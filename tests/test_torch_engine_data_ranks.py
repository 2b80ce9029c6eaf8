"""The serving engine on a pod x data mesh of ranks: ``ServingEngine(api,
mesh=make_mesh((2, 2), ("pod", "data")), backend="pipelined")`` on four
gloo CPU ranks (stage s on the two data ranks of pod s), reduced
llama3.2-1b in f32, one thread a rank.

(a) ``REFERENCE``: the reference's engine on its own (2, 2) mesh of fake
    XLA devices, run once in a subprocess while the ranks serve, over
    ``ENGINE_PIPE_CODE``'s workload (``tests/test_serving.py``: paged and
    timeline, with and without the injected straggler) and the device
    death of ``tests/test_faults.py`` (one device-loss re-plan, streams
    equal to the undisturbed run's). The ranks serve the same streams.
(b) Against the port's one-card pipelined engine on the same params: the
    streams of the same config, sealed and unsealed; and every decode
    step's logits bit for bit against the one-card engine at
    ``microbatches x data`` microbatches, whose stage calls take the rows
    a data rank's take (a CPU GEMM's bits depend on its row count): so
    each data rank's logits, its first step's included, are the one-card
    decoder's at that rank's rows.
(c) One cache a pod: after every engine step the two data ranks of a pod
    hold bit-equal caches (``rank_jobs.param_digest``), on a tight pool
    that swap-preempts and on the reference's demand CI stream (shared
    system prompts: copy-on-write forks). Every rank's events and
    ``stats()`` are equal.
(d) Keys: no (key, counter) pair ciphers twice over the four ranks
    (swaps, prefill crossings, restages, KV exchanges, decode
    boundaries); data rank 0 of each pod seals the pod's part of a swap,
    and the two pods' parts side by side are the one-card payload with its
    ``payload_digest``.
(e) The three-stage repair: over three ranks, sealed at plan (1, 1, 2),
    and on one card at three stages, no (key, counter) pair repeats; at
    two stages the boundary counters are the reference's,
    ``_leaf_counter(t + 1, 0)``.
(f) The serve launcher: the reference's 2 x 2 ``--verify-swap`` line and
    its 2 x 2 demand CI line over four gloo ranks.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.configs import get_arch, reduced
from repro_torch.enclave import sealing
from repro_torch.launch import rank_jobs as J
from repro_torch.launch import serve
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.runtime.pipeline import PipelinedDecoder
from repro_torch.serving import EngineConfig, FaultConfig, ServingEngine
from repro_torch.weights import params_from_jax
from test_torch_engine_ranks import DEATH, DEATH_FAULTS, PIPE, _workloads
from test_torch_serve_ranks import NO_REPLAN, TIGHT

D = 2                                    # data ranks a pod
STRAGGLER = (1, 25.0)                    # ENGINE_PIPE_CODE's inject
DEMAND = ("--slots 4 --microbatches 2 --requests 8 --prompt-len 12 "
          "--max-new 8 --page-size 8 --num-pages 9 --page-policy demand "
          "--shared-system-prompt 0.75 --f32")

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.launch.mesh import make_mesh
from repro.models.api import build_model
from repro.serving import EngineConfig, FaultConfig, ServingEngine

data = pickle.load(open(PATH, "rb"))
cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=128)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
mesh = make_mesh((2, 2), ("pod", "data"))
out = {"params": jax.tree.map(np.asarray, params)}
for kv in ("paged", "timeline"):
    for inject in (None, data["straggler"]):
        ec = EngineConfig(seal_boundary=False, kv_layout=kv, **data["pipe"])
        eng = ServingEngine(api, mesh=mesh, config=ec, params=params,
                            backend="pipelined")
        if inject:
            eng.telemetry.inject(*inject)
        reqs = [eng.submit(p, n) for p, n in data["pipe_wl"]]
        eng.run(max_steps=120)
        assert all(r.status == "done" for r in reqs)
        out[(kv, bool(inject))] = [list(r.generated) for r in reqs]
for name, faults in (("calm", None),
                     ("death", FaultConfig(**data["death_faults"]))):
    ec = EngineConfig(seal_boundary=False, faults=faults, **data["death"])
    eng = ServingEngine(api, mesh=mesh, config=ec, params=params,
                        backend="pipelined")
    reqs, k = [], 0
    while k < len(data["death_wl"]) or eng.scheduler.has_work():
        if k < len(data["death_wl"]):
            reqs.append(eng.submit(*data["death_wl"][k])); k += 1
        eng.step()
        assert eng.steps < 400
    assert all(r.status == "done" for r in reqs)
    st = eng.stats()
    out[name] = ([list(r.generated) for r in reqs],
                 {k: st.get(k) for k in ("failure_replans", "faults",
                                         "recovery")})
pickle.dump(out, open(PATH, "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reference:
    """``REFERENCE`` in a subprocess with 4 fake XLA devices, running while
    the ranks serve (``result()`` waits for it)."""

    def __init__(self, path: str):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE.replace("PATH", repr(path))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def result(self):
        if not hasattr(self, "out"):
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "REFERENCE OK" in out, \
                err[-4000:]
            with open(self.path, "rb") as f:
                self.out = pickle.load(f)
            os.remove(self.path)
        return self.out


def _demand(vocab):
    """The reference's demand CI line (ci.yml:75-81), in f32: its config
    and its stream."""
    args = serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"]
        + DEMAND.split())
    return serve.make_config(args, telemetry_interval=NO_REPLAN), \
        [(p, args.max_new) for p in serve.gen_prompts(args, vocab)], \
        args.arrival_every


def _runs(vocab):
    """name -> ServeRun, each served on the 2 x 2 ranks in one spawn."""
    pipe, death = _workloads(vocab)
    rng = np.random.RandomState(3)
    tight = [(rng.randint(0, vocab, size=int(rng.randint(2, 17))).tolist(),
              int(rng.randint(6, 14))) for _ in range(10)]
    runs = {}
    for kv in ("paged", "timeline"):
        for inject in (None, STRAGGLER):
            runs[(kv, bool(inject))] = J.ServeRun(EngineConfig(
                seal_boundary=False, kv_layout=kv, **PIPE), pipe,
                inject=inject, keep_logits=True, max_steps=120,
                digest_steps=True)
        runs[(kv, "sealed")] = J.ServeRun(EngineConfig(
            kv_layout=kv, **dict(PIPE, telemetry_interval=NO_REPLAN)), pipe,
            keep_logits=True, max_steps=120, digest_steps=True)
    for name, faults in (("calm", None), ("death", DEATH_FAULTS)):
        runs[name] = J.ServeRun(EngineConfig(
            seal_boundary=False, faults=faults and FaultConfig(**faults),
            **DEATH), death, every=1, digest_steps=True)
    runs["tight"] = J.ServeRun(EngineConfig(
        telemetry_interval=NO_REPLAN, **TIGHT), tight, every=1,
        keep_logits=True, check_swaps=True, digest_steps=True)
    config, stream, every = _demand(vocab)
    runs["demand"] = J.ServeRun(config, stream, every=every,
                                keep_logits=True, check_swaps=True,
                                digest_steps=True)
    return runs


# runs whose decode logits are held bit for bit against one card, and
# whose streams are held against the same config on one card
ONE_CARD = [("paged", False), ("timeline", False), ("paged", "sealed"),
            ("timeline", "sealed"), "tight", "demand"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the reference's subprocess, the port's model and params, every
    run's four ranks' results by name)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    cfg = reduced(get_arch("llama3.2-1b"))
    pipe, death = _workloads(cfg.vocab_size)
    path = str(tmp_path_factory.mktemp("data_ranks") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"pipe": PIPE, "pipe_wl": pipe, "death": DEATH,
                     "death_wl": death, "death_faults": DEATH_FAULTS,
                     "straggler": STRAGGLER}, f)
    ref = _Reference(path)
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget("llama3.2-1b")), max_seq=128)
        jparams = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                               if jnp.issubdtype(x.dtype, jnp.floating)
                               else np.asarray(x),
                               japi.init(jax.random.PRNGKey(0)))
    finally:
        JL.DEFAULT_DTYPE = old
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=128)
    params = params_from_jax(jparams, "cpu")
    runs = _runs(cfg.vocab_size)
    out = spawn(J.serve, 4, backend="gloo", device="cpu",
                args=(J.ServeJob(cfg, list(runs.values()), params=params,
                                 max_seq=128, data=D),))
    yield ref, api, params, {name: [r[i] for r in out]
                             for i, name in enumerate(runs)}
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


def one_card(api, params, run, microbatches):
    """``run`` on the port's one-card pipelined engine at ``microbatches``
    microbatches: (streams, decode logits, the first swap-out, stats)."""
    config = dataclasses.replace(run.config,
                                 num_microbatches=microbatches)
    eng = ServingEngine(api, config, params, device="cpu",
                        backend="pipelined")
    if run.inject:
        eng.telemetry.inject(*run.inject)
    probe = J.Probe(eng, True)
    reqs = J.drive(eng, dataclasses.replace(run, config=config))
    return ([list(r.generated) for r in reqs], probe.logits,
            probe.first_swap, eng.stats())


def test_ranks_lie_on_a_pod_by_data_mesh(served):
    ranks = served[3]["tight"]
    assert [(r["stage"], r["data"]) for r in ranks] == [(0, 0), (0, 1),
                                                      (1, 0), (1, 1)]
    for r in ranks:
        lo, hi = r["range"]
        assert (lo, hi) == ((0, 1), (1, 4))[r["stage"]]


@pytest.mark.parametrize("name", ONE_CARD, ids=str)
def test_data_ranks_equal_one_card(served, name):
    _, api, params, ranked = served
    run = _runs(api.cfg.vocab_size)[name]
    streams, _, _, st = one_card(api, params, run, run.config
                                 .num_microbatches)
    split, logits, _, st_split = one_card(api, params, run, D *
                                          run.config.num_microbatches)
    assert split == streams
    for r in ranked[name]:
        assert r["streams"] == streams
        assert len(r["logits"]) == len(logits) > 0
        for got, want in zip(r["logits"], logits):
            assert torch.equal(got, want)
        for k in ("steps", "preemptions", "swap_outs", "swap_ins",
                  "prefill_calls", "forks", "completed", "tokens_out"):
            assert r["stats"].get(k) == st.get(k), k
    if name == "tight":
        assert st["swap_outs"] > 0 and st["swap_ins"] > 0
    if name == "demand":
        assert st["forks"] > 0 and st["swap_outs"] > 0
        assert st["completed"] == len(run.requests)


def test_the_data_ranks_of_a_pod_hold_one_cache(served):
    for name, ranks in served[3].items():
        by = {(r["stage"], r["data"]): r for r in ranks}
        for pod in range(2):
            a, b = by[(pod, 0)], by[(pod, 1)]
            assert len(a["digests"]) == a["stats"]["steps"] > 0, name
            assert a["digests"] == b["digests"], (name, pod)
            assert a["cache_digest"] == b["cache_digest"], (name, pod)
        # every swap-in restored each rank's pages bit for bit
        assert len({r["restored"] for r in ranks}) == 1, name
        if name == "tight":
            assert ranks[0]["restored"] > 0


def test_every_rank_takes_the_same_decisions(served):
    for name, ranks in served[3].items():
        for r in ranks[1:]:
            assert r["events"] == ranks[0]["events"], name
            assert r["stats"] == ranks[0]["stats"], name
            assert r["admission_ms"] == ranks[0]["admission_ms"], name


def test_no_keystream_reuse_over_the_four_ranks(served):
    spaces = set()
    for name, ranks in served[3].items():
        assert not J.keystream_reuse([r["keys"] for r in ranks]), name
        for r in ranks:
            for kind, _, ctr, *_ in r["keys"]:
                seq = (ctr ^ 0xA5A50000) // 2
                if kind == "seal":
                    spaces.add("boundary")
                elif seq >= sealing.RESTAGE_SEQ_BASE:
                    spaces.add("restage")
                elif seq >= sealing.CROSSING_SEQ_BASE:
                    spaces.add("crossing")
                elif seq >= sealing.EXCHANGE_SEQ_BASE:
                    spaces.add("exchange")
                else:
                    spaces.add("swap")
    assert spaces == {"boundary", "restage", "crossing", "exchange",
                      "swap"}, spaces
    # a data rank other than 0 seals no swap part
    for r in served[3]["tight"]:
        swaps = [k for k in r["keys"] if k[0] == "seal_bits"
                 and (k[2] ^ 0xA5A50000) // 2 < sealing.EXCHANGE_SEQ_BASE]
        assert (len(swaps) > 0) == (r["data"] == 0), r["data"]


def test_the_pods_swap_parts_are_the_one_card_payload(served):
    _, api, params, ranked = served
    run = _runs(api.cfg.vocab_size)["tight"]
    want = one_card(api, params, run, D * run.config.num_microbatches)[2]
    parts = {(r["stage"], r["data"]): r["first_swap"] for r in ranked["tight"]}
    assert all(p["counter"] == want["counter"] for p in parts.values())
    whole = tuple(np.concatenate([parts[(pod, 0)]["payload"][i]
                                  for pod in range(2)], axis=1)
                  for i in range(2))
    for a, b in zip(whole, want["payload"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sealing.payload_digest(whole) == want["digest"]
    assert all(p["payload"][0].shape[1] == 0
               for (_, d), p in parts.items() if d > 0)


# ---------------------------------------------------------------------------
# (e) the three-stage repair
# ---------------------------------------------------------------------------
# the non-prefix CI line's planner settings (sandwich topology, delta 2.0)
THREE = dict(num_slots=4, num_stages=3, num_microbatches=2, max_seq=128,
             prompt_capacity=16, delta=2.0, telemetry_interval=NO_REPLAN)


def test_three_sealed_stages_reuse_no_keystream():
    """Sealed at plan (1, 1, 2) over three ranks (the run in which the
    reference's counters repeated five pairs), and on one card at three
    stages: every boundary pair is distinct, the streams are the one
    card's and the one card's equal the unsealed run's tokens."""
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=128)
    params = api.init(torch.Generator().manual_seed(1))
    pipe, _ = _workloads(cfg.vocab_size)
    run = J.ServeRun(EngineConfig(**THREE), [(p, 5) for p, _ in pipe],
                     topology="sandwich")
    ranks = spawn(J.serve, 3, backend="gloo", device="cpu",
                  args=(J.ServeJob(cfg, [run], params=params,
                                   max_seq=128),))
    ranks = [r[0] for r in ranks]
    assert ranks[0]["stats"]["stage_blocks"] == (1, 1, 2)
    assert not J.keystream_reuse([r["keys"] for r in ranks])
    seals = [k for r in ranks for k in r["keys"] if k[0] == "seal"]
    assert len(seals) == 2 * 2 * ranks[0]["decode_steps"]
    with J.KeyLedger() as ledger:
        eng = ServingEngine(api, run.config, params, device="cpu",
                            backend="pipelined",
                            rm=serve.TOPOLOGIES["sandwich"](3))
        reqs = J.drive(eng, run)
    assert eng.stats()["stage_blocks"] == (1, 1, 2)
    assert not J.keystream_reuse([ledger.records])
    assert [list(r.generated) for r in reqs] == ranks[0]["streams"]


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_boundary_counters_one_leaf_a_stage(stages):
    """Stage s seals tick t under ``_leaf_counter(t + 1, s * D + d)``: at
    two stages that is leaf d, the reference's counters (so every
    two-stage payload keeps its bytes), and no counter repeats at any
    stage count, on one card or over data ranks."""
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-1b")),
                              num_layers=12)
    api = build_model(cfg, device="cpu", dtype=torch.float32)
    nm = 3
    dec = PipelinedDecoder(api, stages, nm)
    for data in (1, 2):
        used = []
        for d in range(data):
            c = dec.boundary_counters(d, data)
            assert c.shape == (stages - 1, nm + stages)
            for s in range(stages - 1):
                assert c[s].tolist() == [
                    sealing._leaf_counter(t, s * data + d)
                    for t in range(nm + stages)]
                # microbatch m leaves stage s at tick m + s, sealed under
                # the counter of tick m + s + 1
                used += [int(c[s, m + s + 1]) for m in range(nm)]
        assert len(used) == len(set(used)) == (stages - 1) * nm * data
    if stages == 2:
        assert dec.boundary_counters(0, 1)[0].tolist() == [
            sealing._leaf_counter(t, 0) for t in range(nm + stages)]


def test_two_stage_payloads_keep_their_bytes():
    """The one-card decoder at two stages seals exactly what
    ``sealing.seal_array`` (the reference's ``seal_array(h, key, t + 1)``)
    seals: the counters of the step's seals are ``_leaf_counter(m + 1,
    0)``."""
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=32)
    params = api.init(torch.Generator().manual_seed(0))
    dec = PipelinedDecoder(api, 2, 2)
    cache = api.init_cache(4, 32)
    step = dec.build(paged=False, per_slot_start=False)
    toks = torch.arange(4, dtype=torch.int32)[:, None]
    with J.KeyLedger() as ledger:
        step(params, dec.stage_cache(cache), {"tokens": toks}, 7)
    assert [(k[0], k[1], k[2]) for k in ledger.records] == [
        ("seal", 7, sealing._leaf_counter(m + 1, 0)) for m in range(2)]


# ---------------------------------------------------------------------------
# (f) the launcher over 2 x 2 ranks
# ---------------------------------------------------------------------------
ARGV = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--ranks",
        "gloo", "--mesh", "2x2", "--stages", "2"]


def test_serve_on_a_two_by_two_mesh_swaps_live_token_exact(capfd):
    st = serve.main(ARGV + ["--microbatches", "2", "--slots", "4",
                            "--requests", "6", "--max-new", "8", "--no-seal",
                            "--f32", "--inject-straggler", "1:10",
                            "--verify-swap"])
    out = capfd.readouterr().out
    assert "SWAP-EXACT OK" in out and "2 pods x 2 data" in out
    assert st["swaps"] >= 1 and st["completed"] == 6


def test_serve_runs_the_reference_demand_line_on_four_ranks(capfd):
    st = serve.main(ARGV + DEMAND.replace(" --f32", "").split()
                    + ["--no-seal"])
    assert "2 pods x 2 data" in capfd.readouterr().out
    assert st["completed"] == 8 and not st["failed_requests"]
    assert st["swap_outs"] > 0 and st["forks"] > 0


# ---------------------------------------------------------------------------
# (a) against the reference (its subprocess has run meanwhile)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["paged", "timeline"])
@pytest.mark.parametrize("inject", [False, True])
def test_data_ranks_serve_the_reference_streams(served, kv, inject):
    out = served[0].result()
    for r in served[3][(kv, inject)]:
        assert r["streams"] == out[(kv, inject)]
        if inject:
            assert r["stats"]["swaps"] >= 1
            assert any(k == "swap" and d["migrated"]
                       for _, k, d in r["events"])


def test_device_death_on_the_data_ranks_keeps_the_streams(served):
    out = served[0].result()
    want, jst = out["death"]
    assert out["calm"][0] == want
    for r in served[3]["calm"] + served[3]["death"]:
        assert r["streams"] == want
    for r in served[3]["death"]:
        st = r["stats"]
        assert st["faults"]["device_death"] == 1, st["faults"]
        assert st["recovery"]["device_loss_replans"] == 1
        assert st["recovery"] == jst["recovery"]
        assert st["failure_replans"] == jst["failure_replans"] == 1
        assert st["swap_outs"] > 0


def test_exchange_packing_round_trips_mixed_leaves():
    """The KV exchange moves a step's entries as one float [n, cols] for
    the page cipher: leaves of one f32 or bf16 type side by side, mixed
    types (an int8 cache, a bf16 body with an f32 state) as their bytes
    viewed as bf16; unpacking gives every leaf back bit for bit."""
    from repro_torch.runtime.pipeline import _pack_rows, _unpack_rows
    g = torch.Generator().manual_seed(5)
    same = [torch.randn(3, 2, 4, generator=g) for _ in range(2)]
    mixed = [torch.randn(3, 2, 4, generator=g).to(torch.bfloat16),
             torch.randint(-128, 128, (3, 6), generator=g,
                           dtype=torch.int8),
             torch.randn(3, 5, generator=g)]
    for parts, dtype in ((same, torch.float32),
                         (mixed, torch.bfloat16)):
        packed = _pack_rows(parts)
        assert packed.dtype == dtype and packed.shape[0] == 3
        assert packed.shape[1] * packed.element_size() == sum(
            p[0].numel() * p.element_size() for p in parts)
        for a, b in zip(_unpack_rows(packed, parts), parts):
            assert a.dtype == b.dtype and torch.equal(a, b)
