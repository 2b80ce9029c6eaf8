"""Warmup over ranks: ``ServingEngine(mesh=make_mesh((2, 2), ("pod",
"data")), config=EngineConfig(warmup=True))`` on four gloo CPU ranks,
reduced llama3.2-1b in f32, one thread a rank. Each rank captures its
stage's device work as managed segments between its messages
(``runtime/pipeline.py::rank_segments``, ``serving/ranked.py``); on the
CPU the same passes run eagerly and keep the signature ledger, so a
signature the warmup missed shows as a stall.

(a) Streams: every warmed rank run equals the same run on cold ranks and
    on the port's warmed one-card pipelined engine, paged and timeline,
    sealed and unsealed, with and without the injected straggler (sealed
    runs never re-plan: a sealed boundary moved by a host-timed probe
    changes the bits). The reference's warmed engine on its own (2, 2)
    mesh of fake XLA devices (``REFERENCE``, a subprocess a KV layout,
    running while the ranks serve) serves the straggler runs, paged and
    timeline, each with a live swap onto a toured layout: the ranks serve
    its streams.
(b) Zero post-freeze captures and stalls on every rank, the straggler's
    live swaps included; every rank's events equal and its stats equal
    but for ``PER_RANK``; no (key, counter) pair ciphered twice over the
    four ranks across warmup and serve (``rank_jobs.KeyLedger``).
(c) Slabs: after a swap onto a toured layout and back, every slab and the
    layout's views keep their ``data_ptr()`` (a graph holds addresses:
    the card's failure mode, visible on the CPU); a layout beyond the
    slabs reallocates them and drops the rank's graphs.
(d) The guard: a managed function that messages raises, naming it.
(e) The serve launcher: the reference's two 2 x 2 ``--warmup
    --assert-no-recompile`` CI lines over four gloo ranks.
(f) On the card (marker ``cuda``): warmed rank segments, replayed, give
    the cold ranks' decode logits bit for bit, with equal launches.
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
from repro_torch.launch import rank_jobs as J
from repro_torch.launch import ranks as RK
from repro_torch.launch import serve
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.aot import AotRegistry
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax
from test_torch_engine_ranks import PIPE, _workloads
from test_torch_serve_ranks import NO_REPLAN

D = 2                                    # data ranks a pod
STRAGGLER = (1, 25.0)
# fewer prefill buckets than the default (prompts of 3-8 tokens, 10 new):
# the reference compiles each one at warmup
WARM = dict(PIPE, request_capacity=24)
# stats that are each rank's own by design
PER_RANK = ("graphs", "warmup_s")
# (kv layout, sealed, straggler) of each served pair of runs
CASES = [("paged", False, False), ("paged", False, True),
         ("timeline", False, False), ("timeline", False, True),
         ("paged", True, False), ("timeline", True, False)]

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.launch.mesh import make_mesh
from repro.models.api import build_model
from repro.serving import EngineConfig, ServingEngine

data = pickle.load(open(PATH, "rb"))
cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=128)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
mesh = make_mesh((2, 2), ("pod", "data"))
out = {}
for kv in data["kvs"]:
    ec = EngineConfig(seal_boundary=False, kv_layout=kv, warmup=True,
                      **data["warm"])
    eng = ServingEngine(api, mesh=mesh, config=ec, params=params,
                        backend="pipelined")
    eng.telemetry.inject(*data["straggler"])
    reqs = [eng.submit(p, n) for p, n in data["wl"]]
    eng.run(max_steps=120)
    st = eng.stats()
    assert all(r.status == "done" for r in reqs)
    assert st["post_warmup_compiles"] == 0 and st["swaps"] >= 1, st
    out[kv] = [list(r.generated) for r in reqs]
pickle.dump(out, open(PATH, "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(kv, sealed, straggler, warm):
    return EngineConfig(kv_layout=kv, seal_boundary=sealed, warmup=warm,
                        **dict(WARM, telemetry_interval=(
                            WARM["telemetry_interval"] if not sealed
                            else NO_REPLAN)))


def _runs(vocab):
    """(case, warm) -> ServeRun, each served on the 2 x 2 ranks."""
    pipe, _ = _workloads(vocab)
    return {(case, warm): J.ServeRun(
        _config(*case, warm), pipe, inject=STRAGGLER if case[2] else None,
        keep_logits=True, max_steps=120)
        for case in CASES for warm in (True, False)}


def slab_body(ctx, job):
    """A warmed paged engine on the (2, 2) mesh (``job``: the config and
    the params): the slabs' and the planned views' addresses before and
    after a swap onto each toured layout and back, the stalls after;
    then a swap past the slabs (a layout the warmup did not tour, with
    ``warmup_layouts`` 1) and a request served there."""
    from repro_torch.launch.mesh import make_mesh
    cfg, params = job
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=128)
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    eng = ServingEngine(api, _config("paged", False, False, True), params,
                        device="cpu", backend="pipelined", mesh=mesh)
    be = eng.backend
    seg = api.model.served_segment.name

    def ptrs():
        return [t.data_ptr() for t in leaves(be._param_slab)
                + leaves(be._kv_slab) + leaves(be.params[seg])
                + leaves(be.body)]

    planned, before, toured = eng.stage_blocks, ptrs(), []
    for target in eng._swap_targets():
        eng.try_swap(target)
        toured.append((target, be.capacity, ptrs()[:4]))
        eng.try_swap(planned)
    after = ptrs()
    st = eng.stats()
    out = {"before": before, "after": after, "toured": toured,
           "planned": planned, "capacity": be.capacity,
           "compiles": st["post_warmup_compiles"],
           "stalls": st["compile_stalls"], "swaps": st["swaps"]}
    # a layout past the slabs: one tour only, so (3, 1) is never warmed
    eng = ServingEngine(api, dataclasses.replace(
        _config("paged", False, False, True), warmup_layouts=1), params,
        device="cpu", backend="pipelined", mesh=mesh)
    be = eng.backend
    cap, old = be.capacity, ptrs()[:4]
    eng.try_swap((3, 1))
    out["grown"] = (cap, be.capacity, be.reallocations, old != ptrs()[:4],
                    len(eng.aot.post_freeze_stalls))
    req = eng.submit([5, 6, 7], 3)
    eng.run(max_steps=20)
    out["grown_stalls"] = [x.describe() for x in eng.aot.post_freeze_stalls]
    out["grown_stream"] = list(req.generated)
    return out


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


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the reference's subprocesses by KV layout, the port's model and
    params, every run's four ranks' results by (case, warm), the slab
    body's four)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    cfg = reduced(get_arch("llama3.2-1b"))
    pipe, _ = _workloads(cfg.vocab_size)
    refs = {}
    for kv in ("paged", "timeline"):
        path = str(tmp_path_factory.mktemp("warm_ranks") / f"{kv}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"warm": WARM, "wl": pipe, "straggler": STRAGGLER,
                         "kvs": [kv]}, f)
        refs[kv] = _Reference(path)
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
    out = spawn(J.chain, 4, backend="gloo", device="cpu", args=([
        (J.serve, J.ServeJob(cfg, list(runs.values()), params=params,
                             max_seq=128, data=D)),
        (slab_body, (cfg, params))],))
    yield refs, api, params, {key: [r[0][i] for r in out]
                              for i, key in enumerate(runs)}, \
        [r[1] for r in out]
    for ref in refs.values():
        if ref.proc.poll() is None:
            ref.proc.kill()
            ref.proc.wait()


def one_card(api, params, run):
    """``run`` on the port's one-card pipelined engine: its streams."""
    eng = ServingEngine(api, run.config, params, device="cpu",
                        backend="pipelined")
    if run.inject:
        eng.telemetry.inject(*run.inject)
    assert eng.aot.post_freeze_stalls == []
    return [list(r.generated) for r in J.drive(eng, run)]


# ---------------------------------------------------------------------------
# (a) streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=str)
def test_warmed_ranks_serve_cold_and_one_card_streams(served, case):
    _, api, params, ranked, _ = served
    warm, cold = ranked[(case, True)], ranked[(case, False)]
    want = one_card(api, params, _runs(api.cfg.vocab_size)[(case, True)])
    for w, c in zip(warm, cold):
        assert w["status"] == ["done"] * len(want), w["status"]
        assert w["streams"] == c["streams"] == want
        assert len(w["logits"]) == len(c["logits"]) > 0
    if case[2]:
        assert warm[0]["stats"]["swaps"] >= 1, warm[0]["events"]


# ---------------------------------------------------------------------------
# (b) no capture after warmup, one decision everywhere, no keystream reuse
# ---------------------------------------------------------------------------
def test_no_post_warmup_capture_or_stall_on_any_rank(served):
    ranked = served[3]
    for (case, warm), ranks in ranked.items():
        for r in ranks:
            st = r["stats"]
            assert r["stalls"] == [] and st["compile_stalls"] == [], \
                (case, r["stalls"])
            if warm:
                assert r["post_warmup_compiles"] == 0
                assert st["warmed"] and r["warmup_s"] > 0
            else:
                assert r["post_warmup_compiles"] is None
            if case[2]:
                # every live swap lands on a layout the warmup toured
                blocks = {tuple(d["to"]) for _, kind, d in r["events"]
                          if kind == "swap"}
                assert blocks and blocks <= {(1, 3), (2, 2), (3, 1)}


def test_every_rank_takes_the_same_decisions(served):
    for key, ranks in served[3].items():
        for r in ranks[1:]:
            assert r["events"] == ranks[0]["events"], key
            assert {k: v for k, v in r["stats"].items()
                    if k not in PER_RANK} == {
                k: v for k, v in ranks[0]["stats"].items()
                if k not in PER_RANK}, key
        # a decode step's split: each rank timed its segments and messages
        for r in ranks:
            assert len(r["step_splits"]) == r["decode_steps"] > 0
            assert all(a > 0 and b > 0 for a, b in r["step_splits"])


def test_no_keystream_reuse_across_warmup_and_serve(served):
    for (case, warm), ranks in served[3].items():
        bad = J.keystream_reuse([r["keys"] for r in ranks])
        assert not bad, (case, warm, bad[:3])
        if warm:
            # the warmed run seals more than the cold one: its warmup
            cold = served[3][(case, False)]
            assert all(len(w["keys"]) > len(c["keys"])
                       for w, c in zip(ranks, cold)), case


# ---------------------------------------------------------------------------
# (c) slabs keep their addresses
# ---------------------------------------------------------------------------
def test_slabs_keep_their_addresses_across_toured_swaps(served):
    for r in served[4]:
        assert r["before"] == r["after"]
        assert r["swaps"] == 2 * len(r["toured"]) > 0
        for target, cap, ptrs in r["toured"]:
            assert cap == r["capacity"] and ptrs == r["before"][:4], target
        assert r["compiles"] == 0 and r["stalls"] == []
        cap, grown, reallocs, moved, stalls = r["grown"]
        # pod 0's slabs grow from 2 layers to 3 (the tour held (1, 3) and
        # (2, 2)); pod 1's hold 3 already
        assert (cap, grown) in ((2, 3), (3, 3)) and moved == (cap < grown)
        assert reallocs == (1 if cap < grown else 0) and stalls == 0
        # the untoured layout's segments are stalls on every rank
        assert r["grown_stalls"], r
        assert r["grown_stream"] == served[4][0]["grown_stream"]
    api, params = served[1], served[2]
    assert served[4][0]["grown_stream"] == one_card(api, params, J.ServeRun(
        _config("paged", False, False, False), [([5, 6, 7], 3)]))[0]


# ---------------------------------------------------------------------------
# (d) the guard
# ---------------------------------------------------------------------------
def test_a_managed_function_that_messages_raises_by_name():
    reg = AotRegistry(capture=False)
    post = reg.wrap("posts", lambda x: RK.send(RK.Staging(), [x], 1))
    with pytest.raises(RuntimeError, match="'posts'"):
        post(torch.zeros(2))
    share = reg.wrap("shares", lambda x: RK.share([1.0], 0))
    with pytest.raises(RuntimeError, match="share inside the managed "
                       "function 'shares'"):
        share(torch.zeros(2))
    # outside a managed call the guard is down again
    assert RK._QUIET == []


# ---------------------------------------------------------------------------
# (e) the reference's two 2 x 2 warmup CI lines
# ---------------------------------------------------------------------------
ARGV = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--ranks",
        "gloo", "--mesh", "2x2", "--stages", "2", "--microbatches", "2",
        "--slots", "4", "--max-new", "8", "--no-seal", "--f32", "--warmup",
        "--assert-no-recompile"]


def test_warmup_ci_lines_on_a_two_by_two_mesh(capfd):
    st = serve.main(ARGV + ["--requests", "6", "--inject-straggler", "1:10",
                            "--verify-swap"])
    out = capfd.readouterr().out
    assert "SWAP-EXACT OK" in out and "NO-RECOMPILE OK" in out, out
    assert "every one of 4 ranks" in out
    assert st["swaps"] >= 1 and st["post_warmup_compiles"] == 0
    st = serve.main(ARGV + ["--requests", "8", "--prompt-len", "24",
                            "--page-size", "8", "--prefill-chunk", "6",
                            "--verify-chunked"])
    out = capfd.readouterr().out
    assert "CHUNK-EXACT OK" in out and "NO-RECOMPILE OK" in out, out
    assert st["chunked_admissions"] > 0


# ---------------------------------------------------------------------------
# (a) against the reference, last: its subprocess ran meanwhile
# ---------------------------------------------------------------------------
def test_warmed_ranks_serve_the_reference_warmed_streams(served):
    refs, _, _, ranked, _ = served
    for kv, ref in refs.items():
        want = ref.result()[kv]
        for r in ranked[((kv, False, True), True)]:
            assert r["streams"] == want, (kv, r["stage"], r["data"])


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["paged", "timeline"])
def test_replayed_rank_segments_bit_equal_eager(cuda, kv):
    cfg = reduced(get_arch("llama3.2-1b"))
    pipe, _ = _workloads(cfg.vocab_size)
    runs = [J.ServeRun(_config(kv, True, False, warm), pipe,
                       keep_logits=True, max_steps=120)
            for warm in (False, True)]
    out = spawn(J.serve, 4, backend="gloo", device=cuda, args=(
        J.ServeJob(cfg, runs, max_seq=128, data=D),))
    for cold, warm in out:
        assert warm["post_warmup_compiles"] == 0 and warm["stalls"] == []
        assert warm["graphs"] > 0 and cold["graphs"] == 0
        assert warm["streams"] == cold["streams"]
        assert len(warm["logits"]) == len(cold["logits"]) > 0
        assert all(torch.equal(a, b)
                   for a, b in zip(warm["logits"], cold["logits"]))
        assert warm["launches"] == cold["launches"]
        assert warm["cache_digest"] == cold["cache_digest"]
