"""The port's control plane against the JAX package's: cost model,
planner, trust-domain registry, replanner and stage telemetry.

All of it is host code (Python floats, no device work), copied into the
port with its imports pointed at ``repro_torch``. So every answer must be
equal, not close: the same layer profiles, the same best placement from
every solver in both search spaces (``t_chunk`` within 1e-12 relative),
the same serving plans ((1, 15) for full-width llama3.2-1b, (8, 20) for
llama3.2-3b, (4, 20) for qwen2-moe-a2.7b and (1, 3) for reduced
llama3.2-1b over two enclaves), and the same sequence of re-plans
from the same stage-time observations with a straggler injected.
"""
import dataclasses

import numpy as np
import pytest

from conftest import random_placement_instance
from repro_torch.configs import get_arch, reduced
from repro_torch.core import cost_model as CM
from repro_torch.core.planner import (LayerProfile, ResourceGraph,
                                      profiles_from_arch, solve)
from repro_torch.enclave.domain import (default_two_pod_manager,
                                        sandwich_manager, two_enclave_manager)
from repro_torch.runtime.ft import HeartbeatMonitor, OnlineReplanner
from repro_torch.serving.telemetry import StageTelemetry

SOLVERS = ["exhaustive", "dp", "beam"]


@pytest.fixture(scope="module")
def J():
    """The reference's modules under the port's names."""
    import types

    from repro.configs import get_arch as jget
    from repro.configs import reduced as jreduced
    from repro.core.planner import profiles_from_arch as jprofiles
    from repro.core.planner import solve as jsolve
    from repro.enclave import domain as jdomain
    from repro.runtime.ft import HeartbeatMonitor as JMonitor
    from repro.runtime.ft import OnlineReplanner as JReplanner
    from repro.serving.telemetry import StageTelemetry as JTelemetry
    return types.SimpleNamespace(
        get_arch=jget, reduced=jreduced, profiles_from_arch=jprofiles,
        solve=jsolve, domain=jdomain, HeartbeatMonitor=JMonitor,
        OnlineReplanner=JReplanner, StageTelemetry=JTelemetry)


def _archs(J):
    full, jfull = get_arch("llama3.2-1b"), J.get_arch("llama3.2-1b")
    return [(full, jfull), (reduced(full), J.reduced(jfull))]


def _port_instance(profs, graph):
    """The reference's random instance rebuilt from the port's classes."""
    devs = {k: CM.DeviceProfile(**dataclasses.asdict(d))
            for k, d in graph.devices.items()}
    link = CM.LinkProfile(**dataclasses.asdict(graph.default_link))
    return ([LayerProfile(**dataclasses.asdict(p)) for p in profs],
            ResourceGraph(devs, {}, link))


def _outcome(fn, *args, **kw):
    """``fn``'s result, or the name of the error it raised: the two
    packages raise their own (equally named) exception classes."""
    try:
        return fn(*args, **kw)
    except Exception as e:              # noqa: BLE001 - compared by name
        return f"raised {type(e).__name__}"


def _same_eval(a, b):
    assert a.placement.describe() == b.placement.describe()
    assert a.feasible == b.feasible
    assert abs(a.t_chunk - b.t_chunk) <= 1e-12 * abs(b.t_chunk)
    np.testing.assert_allclose(a.stage_times, b.stage_times, rtol=1e-12)
    assert a.max_similarity == b.max_similarity


def test_cost_model_constants_are_the_reference_inputs():
    from repro.core import cost_model as JCM
    for name in ("TEE", "CPU", "GPU", "TPU_POD", "TPU_POD_TRUSTED",
                 "WAN_30MBPS", "DCN_LINK"):
        assert dataclasses.asdict(getattr(CM, name)) == \
            dataclasses.asdict(getattr(JCM, name)), name
    assert CM.RUNTIME_FOOTPRINT == JCM.RUNTIME_FOOTPRINT


def test_profiles_from_arch_equal(J):
    for cfg, jcfg in _archs(J):
        for seq_len in (1, 16):
            got = profiles_from_arch(cfg, seq_len=seq_len)
            want = J.profiles_from_arch(jcfg, seq_len=seq_len)
            assert [dataclasses.astuple(p) for p in got] == \
                [dataclasses.astuple(p) for p in want]
    # the reference's fallback (tests/test_serving.py): the flag without
    # an artifact, or with one that cannot be read, gives the constants
    # (a count is held against the reference's hlo_calibration in
    # tests/test_torch_steps_mesh.py)
    for cfg, jcfg in _archs(J):
        got = profiles_from_arch(cfg, 1, calibrate_from_hlo=True)
        want = J.profiles_from_arch(jcfg, 1, calibrate_from_hlo=True)
        assert [dataclasses.astuple(p) for p in got] == \
            [dataclasses.astuple(p) for p in want] == \
            [dataclasses.astuple(p) for p in profiles_from_arch(cfg, 1)]
        got = profiles_from_arch(cfg, 1, calibrate_from_hlo=True,
                                 compiled=object())
        want = J.profiles_from_arch(jcfg, 1, calibrate_from_hlo=True,
                                    compiled=object())
        assert [dataclasses.astuple(p) for p in got] == \
            [dataclasses.astuple(p) for p in want] == \
            [dataclasses.astuple(p) for p in profiles_from_arch(cfg, 1)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("space", ["prefix", "segment"])
def test_solvers_equal_on_random_instances(J, seed, space):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(2, 8))
    r = int(rng.integers(1, 3))
    u = int(rng.integers(0, 3))
    jprofs, jgraph = random_placement_instance(rng, m, r, u)
    profs, graph = _port_instance(jprofs, jgraph)
    n = int(rng.integers(1, 5000))
    delta = float(rng.uniform(0.05, 1.0))
    for s in SOLVERS:
        want = _outcome(J.solve, jprofs, jgraph, n=n, delta=delta, solver=s,
                        space=space)
        got = _outcome(solve, profs, graph, n=n, delta=delta, solver=s,
                       space=space)
        if isinstance(want, str):
            assert got == want, s
            continue
        _same_eval(got.best, want.best)
        assert (got.solver, got.n_candidates, got.n_feasible, got.n_pruned,
                got.truncated) == (want.solver, want.n_candidates,
                                   want.n_feasible, want.n_pruned,
                                   want.truncated)


def _plan_like_the_engine(rp):
    """``ServingEngine``'s planning: ask for every stage, and drop the
    stage floor when the topology cannot supply it."""
    try:
        return rp.plan()
    except Exception as e:              # either package's InfeasibleError
        assert type(e).__name__ == "InfeasibleError", e
        rp.min_stages = None
        return rp.plan()


@pytest.mark.parametrize("topology,args", [
    ("two_enclave_manager", ()), ("default_two_pod_manager", ()),
    ("sandwich_manager", (2,))])
def test_serving_plans_equal(J, topology, args):
    """The plan the engine starts from (min_stages=2, as with --stages 2):
    over two enclaves, (1, 15) at full width and (1, 3) reduced."""
    mk = {"two_enclave_manager": two_enclave_manager,
          "default_two_pod_manager": default_two_pod_manager,
          "sandwich_manager": sandwich_manager}[topology]
    for (cfg, jcfg), blocks in zip(_archs(J), ((1, 15), (1, 3))):
        got = OnlineReplanner(mk(*args), profiles_from_arch(cfg, 1),
                              n=10_000, delta=0.5, min_stages=2)
        want = J.OnlineReplanner(getattr(J.domain, topology)(*args),
                                 J.profiles_from_arch(jcfg, 1), n=10_000,
                                 delta=0.5, min_stages=2)
        wspec = _plan_like_the_engine(want)
        gspec = _plan_like_the_engine(got)
        assert got.min_stages == want.min_stages
        assert gspec.describe() == wspec.describe()
        assert gspec.stage_sizes() == wspec.stage_sizes()
        _same_eval(got.current, want.current)
        if topology == "two_enclave_manager":
            assert gspec.stage_sizes() == blocks


@pytest.mark.parametrize("name,blocks", [
    ("llama3.2-1b", (1, 15)), ("llama3.2-3b", (8, 20)),
    ("qwen2-moe-a2.7b", (4, 20))])
def test_full_width_serving_plans_equal(J, name, blocks):
    """The plan a two-stage engine starts from at full width, with the
    engine's own planning defaults: the same profiles (an MoE block's
    bytes count every expert, its FLOPs only the routed-to ones) and the
    same placement as the reference's."""
    from repro_torch.serving import EngineConfig
    ec = EngineConfig()
    cfg, jcfg = get_arch(name), J.get_arch(name)
    profs, jprofs = profiles_from_arch(cfg, 1), J.profiles_from_arch(jcfg, 1)
    assert [dataclasses.astuple(p) for p in profs] == \
        [dataclasses.astuple(p) for p in jprofs]
    kw = dict(n=ec.plan_n, delta=ec.delta, solver=ec.solver, space=ec.space,
              min_stages=2)
    gspec = OnlineReplanner(two_enclave_manager(), profs, **kw).plan()
    wspec = J.OnlineReplanner(J.domain.two_enclave_manager(), jprofs,
                              **kw).plan()
    assert gspec.describe() == wspec.describe()
    assert gspec.stage_sizes() == wspec.stage_sizes() == blocks


def _telemetry(mk_rm, Replanner, Telemetry, Monitor, profiles):
    rm = mk_rm()
    rp = Replanner(rm, profiles, n=10_000, delta=0.5, min_stages=2)
    rp.plan()
    tel = Telemetry(rp, monitor=Monitor(rm, timeout_s=3600.0), interval=2)
    return rm, rp, tel


def test_replanner_and_telemetry_follow_the_same_observations(J):
    """A fixed sequence of stage times, a straggler injected on stage 1 and
    later cleared, then a dead domain: both packages re-plan at the same
    steps to the same specs, derate the same devices and exclude the same
    corpse."""
    cfg, jcfg = _archs(J)[1]
    rm, rp, tel = _telemetry(two_enclave_manager, OnlineReplanner,
                             StageTelemetry, HeartbeatMonitor,
                             profiles_from_arch(cfg, 1))
    jrm, jrp, jtel = _telemetry(J.domain.two_enclave_manager,
                                J.OnlineReplanner, J.StageTelemetry,
                                J.HeartbeatMonitor,
                                J.profiles_from_arch(jcfg, 1))
    rng = np.random.RandomState(0)
    seen = []
    for step in range(1, 41):
        if step == 6:
            tel.inject(1, 10.0)
            jtel.inject(1, 10.0)
        if step == 20:
            tel.inject(1, 1.0)
            jtel.inject(1, 1.0)
        wall = float(rng.uniform(0.01, 0.02))
        noise = rng.uniform(0.95, 1.05, size=2)
        for t, r in ((tel, rp), (jtel, jrp)):
            t.record_step(wall)
            if step % t.interval == 0:
                # on plan, up to 5% noise: only the straggler deviates
                t.record_stage_times([float(p * f) for p, f in
                                      zip(r.current.stage_times, noise)])
        if step == 30:                  # after this tick's heartbeats
            for r in (rm, jrm):
                r.mark_unhealthy("pod1")
        want = _outcome(jtel.maybe_observe, step)
        got = _outcome(tel.maybe_observe, step)
        if want is None or isinstance(want, str):
            assert got == want, step
        else:
            assert got.describe() == want.describe(), step
            seen.append((step, got.describe()))
        assert tel.scaled_observations() == pytest.approx(
            jtel.scaled_observations(), rel=1e-12)
        assert (rp.replans, rp.failure_replans, rp.excluded_devices) == \
            (jrp.replans, jrp.failure_replans, jrp.excluded_devices)
        assert [d.derate_factor for d in rm.domains()] == \
            pytest.approx([d.derate_factor for d in jrm.domains()],
                          rel=1e-12)
    # every tick re-plans while the straggler lasts, none once it is
    # cleared, and the dead domain forces one failure re-plan
    assert [st for st, _ in seen] == [6, 8, 10, 12, 14, 16, 18, 30], seen
    assert (rp.replans, rp.failure_replans, rp.excluded_devices) == \
        (8, 1, ["pod1"])
    assert tel.wall_s == pytest.approx(jtel.wall_s, rel=1e-12)
    assert tel.predicted_shares() == pytest.approx(jtel.predicted_shares(),
                                                   rel=1e-12)
