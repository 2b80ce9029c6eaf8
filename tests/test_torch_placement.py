"""The paper's placement path through the port against the JAX package
(CPU, host code only).

``core/pipeline_sim.py`` must give the reference's completion time,
per-frame departures and busy times, and equal Eq. 1-2's closed form, for
any stage and link times (hypothesis, as ``tests/test_property.py``).
The ``core/placement.py`` shim's legacy ``solve`` must return the
reference shim's argmin and every evaluation, equal to the last bit, on
the five CNN tables of ``models/cnn.py``. The paper's Fig. 12 claims of
``tests/test_placement.py`` are asserted on the port's own planner and
tables, and the speedups behind them must equal the reference's.
"""
import dataclasses
import types

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import pipeline_sim as JS
from repro.core import placement as JP
from repro.models import cnn as JC
from repro_torch.core import cost_model as CM
from repro_torch.core import planner_solve as plan_solve
from repro_torch.core.pipeline_sim import (closed_form_completion,
                                           simulate_pipeline)
from repro_torch.core.placement import (LayerProfile, Placement,
                                        PlacementSpec, ResourceGraph, Stage,
                                        _stage_exec, enumerate_placements,
                                        evaluate, profiles_from_cnn, solve)
from repro_torch.core.privacy import resolution_similarity
from repro_torch.models.cnn import CNN_MODELS

DELTA = resolution_similarity(20)
N = 10_800
SETTINGS = settings(deadline=None, max_examples=25,
                    suppress_health_check=[HealthCheck.too_slow])


def graph(devs):
    return ResourceGraph(devs, {}, CM.WAN_30MBPS)


def tee2():
    return dataclasses.replace(CM.TEE, name="tee2")


def full_graph():
    return graph({"tee1": CM.TEE, "tee2": tee2(), "gpu": CM.GPU})


def _jgraph(g):
    """The reference's ResourceGraph over the same device and link
    profiles (the port's profiles are copies with equal fields)."""
    from repro.core import cost_model as JCM
    devs = {k: JCM.DeviceProfile(**dataclasses.asdict(d))
            for k, d in g.devices.items()}
    return JP.ResourceGraph(devs, {}, JCM.LinkProfile(
        **dataclasses.asdict(g.default_link)))


def _ev(e):
    return (e.placement.describe(), e.stage_times, e.link_times,
            e.bottleneck, e.t_chunk, e.t_frame, e.max_similarity,
            e.feasible)


def _sim_equal(stages, links, n):
    got = simulate_pipeline(stages, links, n)
    want = JS.simulate_pipeline(stages, links, n)
    assert (got.completion_time, got.per_frame_departure, got.busy_time) \
        == (want.completion_time, want.per_frame_departure, want.busy_time)
    assert got.utilization() == want.utilization()
    cf = closed_form_completion(stages, links, n)
    assert cf == JS.closed_form_completion(stages, links, n)
    assert abs(got.completion_time - cf) <= 1e-6 * max(cf, 1.0)


@SETTINGS
@given(st.lists(st.floats(1e-4, 10.0), min_size=1, max_size=6),
       st.integers(1, 200))
def test_pipeline_closed_form_is_exact(stages, n):
    _sim_equal(stages, [s / 7 for s in stages[1:]], n)


@SETTINGS
@given(st.lists(st.floats(1e-3, 5.0), min_size=2, max_size=6),
       st.integers(1, 500))
def test_uneven_stage_sim_matches_closed_form(stages, n):
    _sim_equal(stages, [abs(a - b) / 3 + 1e-4
                        for a, b in zip(stages, stages[1:])], n)


def test_closed_form_matches_discrete_event_sim():
    stage_times = [0.4, 0.25, 0.05]
    link_times = [0.08, 0.02]
    for n in (1, 2, 10, 500):
        sim = simulate_pipeline(stage_times, link_times, n)
        cf = closed_form_completion(stage_times, link_times, n)
        assert abs(sim.completion_time - cf) / cf < 1e-9
    assert simulate_pipeline([1.0], [], 0).completion_time == 0.0


@pytest.mark.parametrize("model", sorted(CNN_MODELS))
@pytest.mark.parametrize("pipelined", [True, False])
def test_legacy_solve_equals_reference(model, pipelined):
    profs = profiles_from_cnn(CNN_MODELS[model])
    jprofs = JP.profiles_from_cnn(JC.CNN_MODELS[model])
    g = full_graph()
    best, evals = solve(profs, g, n=N, delta=DELTA, pipelined=pipelined)
    jbest, jevals = JP.solve(jprofs, _jgraph(g), n=N, delta=DELTA,
                             pipelined=pipelined)
    assert _ev(best) == _ev(jbest)
    assert [_ev(e) for e in evals] == [_ev(e) for e in jevals]
    for s in best.placement.stages:
        jstage = JP.Stage(s.device, s.start, s.end)
        assert _stage_exec(profs, s, g.devices[s.device]) == \
            JP._stage_exec(jprofs, jstage, _jgraph(g).devices[s.device])


def test_tree_size_matches_paper_analysis():
    """Paper Sec. V: with 2 TEEs + suffix device, N = O(M^2)."""
    M = 7
    g = graph({"tee1": CM.TEE, "tee2": tee2(), "e2": CM.CPU})
    paths = list(enumerate_placements(M, g))
    assert len(paths) > M
    for p in paths:
        assert p.stages[0].start == 0
        for a, b in zip(p.stages, p.stages[1:]):
            assert a.end == b.start
        assert p.stages[-1].end == M


def test_first_stage_always_trusted():
    profs = profiles_from_cnn(CNN_MODELS["alexnet"])
    bad = Placement((Stage("gpu", 0, len(profs)),))
    assert not evaluate(bad, profs, full_graph(), N, DELTA).feasible


def test_privacy_constraint_enforced():
    profs = profiles_from_cnn(CNN_MODELS["alexnet"])
    _, evals = solve(profs, full_graph(), n=N, delta=DELTA)
    assert any(ev.feasible for ev in evals)
    for ev in evals:
        if ev.feasible:
            assert ev.max_similarity < DELTA


def test_evaluation_matches_simulator():
    profs = profiles_from_cnn(CNN_MODELS["googlenet"])
    best, _ = solve(profs, full_graph(), n=N, delta=DELTA)
    sim = simulate_pipeline(best.stage_times, best.link_times, N)
    assert abs(sim.completion_time - best.t_chunk) / best.t_chunk < 1e-9


PORT = types.SimpleNamespace(
    profiles_from_cnn=profiles_from_cnn, evaluate=evaluate, solve=solve,
    Placement=Placement, Stage=Stage, models=CNN_MODELS, graph=lambda g: g)
REF = types.SimpleNamespace(
    profiles_from_cnn=JP.profiles_from_cnn, evaluate=JP.evaluate,
    solve=JP.solve, Placement=JP.Placement, Stage=JP.Stage,
    models=JC.CNN_MODELS, graph=_jgraph)


def speedups(model, P=PORT):
    """Fig. 12's bars for one CNN: 1 TEE against 2 TEEs, TEE+GPU, the
    proposed placement and no pipelining (``tests/test_placement.py``),
    through the port's planner, or the reference's with ``P=REF``."""
    profs = P.profiles_from_cnn(P.models[model])
    g_all = P.graph(full_graph())
    base = P.evaluate(P.Placement((P.Stage("tee1", 0, len(profs)),)), profs,
                      g_all, N, DELTA)
    out = {}
    for name, devs in (("tee+gpu", {"tee1": CM.TEE, "gpu": CM.GPU}),
                       ("2tee", {"tee1": CM.TEE, "tee2": tee2()})):
        b, _ = P.solve(profs, P.graph(graph(devs)), n=N, delta=DELTA)
        out[name] = base.t_chunk / b.t_chunk
    b, _ = P.solve(profs, g_all, n=N, delta=DELTA)
    out["proposed"] = base.t_chunk / b.t_chunk
    b, _ = P.solve(profs, g_all, n=N, delta=DELTA, pipelined=False)
    out["nopipe"] = base.t_chunk / P.evaluate(b.placement, profs, g_all, N,
                                              DELTA).t_chunk
    return out


@pytest.mark.parametrize("model", sorted(CNN_MODELS))
def test_fig12_speedups_equal_reference(model):
    assert speedups(model) == speedups(model, REF)


def test_paper_claim_2tee_beats_gpu_for_back_heavy_models():
    """Fig. 12: GoogLeNet/MobileNet/SqueezeNet gain more from 2 TEEs than
    from TEE+GPU (their privacy boundary sits deep in the network)."""
    for m in ("googlenet", "mobilenet", "squeezenet"):
        s = speedups(m)
        assert s["2tee"] > s["tee+gpu"], (m, s)
        assert 1.5 < s["2tee"] < 2.1, (m, s)


def test_paper_claim_gpu_beats_2tee_for_front_light_models():
    """Fig. 12: AlexNet reaches the privacy threshold early -> TEE+GPU wins."""
    s = speedups("alexnet")
    assert s["tee+gpu"] > s["2tee"], s
    assert 2.2 <= s["tee+gpu"] <= 3.6, s


def test_paper_claim_proposed_best_and_headline():
    best = 0.0
    for m in CNN_MODELS:
        s = speedups(m)
        assert s["proposed"] >= s["2tee"] - 1e-9, (m, s)
        assert s["proposed"] >= s["tee+gpu"] - 1e-9, (m, s)
        best = max(best, s["proposed"])
    assert 3.5 < best < 5.5, best   # paper headline: up to 4.7x


def test_paper_claim_nopipe_equals_teegpu_decision():
    """Fig. 12 note: the single-frame objective picks the TEE+GPU split."""
    for m in CNN_MODELS:
        profs = profiles_from_cnn(CNN_MODELS[m])
        b, _ = solve(profs, full_graph(), n=N, delta=DELTA, pipelined=False)
        devs = {s.device for s in b.placement.stages}
        assert "tee2" not in devs or len(b.placement.stages) <= 2, \
            (m, b.placement)


# ---------------------------------------------------------------------------
# Segment space through the shim's names (tests/test_placement.py)
# ---------------------------------------------------------------------------
def sandwich_instance(m=8, bump_at=3):
    sims = [0.3] * m
    sims[bump_at - 1] = 0.9             # input of layer bump_at is exposed
    profs = [LayerProfile(f"l{i}", 2e8, 2e5, sims[i], params_bytes=1e6)
             for i in range(m)]
    g = graph({"tee1": CM.TEE, "tee2": tee2(), "gpu0": CM.GPU,
               "gpu1": dataclasses.replace(CM.GPU, name="gpu1")})
    return profs, g


def test_non_prefix_optimum_slow_enclave_sandwich():
    profs, g = sandwich_instance()
    px = solve(profs, g, n=N, delta=0.5)[0]
    sg = plan_solve(profs, g, n=N, delta=0.5, solver="segment-dp")
    so = plan_solve(profs, g, n=N, delta=0.5, solver="segment-exhaustive")
    assert abs(sg.best.t_chunk - so.best.t_chunk) <= 1e-9 * so.best.t_chunk
    assert sg.best.t_chunk < px.t_chunk * (1 - 1e-6)
    spec = PlacementSpec.from_placement(sg.best.placement, g)
    assert not spec.is_prefix(g)
    doms = spec.domains()
    assert any(doms[i] == "trusted" and "untrusted" in doms[:i]
               and "untrusted" in doms[i + 1:] for i in range(len(doms)))
    spec.validate(len(profs), g)
    assert sg.best.feasible and sg.best.max_similarity < 0.5


def test_non_prefix_optimum_two_untrusted_segments():
    profs = [LayerProfile(f"l{i}", 1e6 if i == 0 else 2e9, 2e5, 0.3,
                          params_bytes=1e6) for i in range(8)]
    g = graph({"tee1": CM.TEE, "gpu0": CM.GPU,
               "gpu1": dataclasses.replace(CM.GPU, name="gpu1")})
    px = solve(profs, g, n=N, delta=0.5)[0]
    sg = plan_solve(profs, g, n=N, delta=0.5, solver="segment-dp")
    assert sg.best.t_chunk < px.t_chunk * (1 - 1e-6)
    spec = PlacementSpec.from_placement(sg.best.placement, g)
    assert not spec.is_prefix(g)
    assert spec.domains().count("untrusted") == 2


def test_segment_evaluate_enforces_privacy_on_interior_segments():
    profs, g = sandwich_instance()
    bad = Placement((Stage("tee1", 0, 1), Stage("gpu0", 1, 4),
                     Stage("tee2", 4, 8)))
    ev = evaluate(bad, profs, g, N, 0.5)
    assert not ev.feasible and ev.max_similarity >= 0.5
    good = Placement((Stage("tee1", 0, 1), Stage("gpu0", 1, 3),
                      Stage("tee2", 3, 8)))
    assert evaluate(good, profs, g, N, 0.5).feasible
