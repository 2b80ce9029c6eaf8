"""The pipelined serving path of the PyTorch port: ``PipelinedDecoder``
(stages in sequence on one device, sealed int8 boundaries) and the
engine's ``PagedPipelinedBackend``.

(a) Unsealed, the pipelined step equals the port's own ``decode_paged_fn``
    within 1e-5 on logits and pools, for even and uneven stage layouts, on
    reduced llama3.2-1b in f32, on a GQA variant (2 KV heads) and on
    reduced qwen2-moe-a2.7b at 4 layers (MoE blocks, attention biases
    drawn nonzero).
(b) Sealed, the port's step matches the reference ``PipelinedDecoder`` on
    the same parameters, pools and tokens: logits and pools within 1e-3 of
    the largest magnitude (both sides quantize each boundary identically
    apart from rounding ties, where one int8 step, 1/127 of the row's
    absmax, may differ).
(c) With ``backend="pipelined"`` the port's engine serves the reference
    engine's greedy streams, seal on and off, under a pool tight enough to
    swap-preempt, with telemetry too rare to re-plan.
(d) Within the port, an injected straggler forces a live boundary swap
    and the unsealed streams equal an undisturbed run's (the reference's
    ``--verify-swap``).
(e) A spy on ``ops.seal`` / ``ops.unseal`` counts ``nm * (S - 1)`` calls
    of each per step.

The reference runs once, in a subprocess with 4 fake XLA devices (its
``shard_map`` pipeline needs a ``pod`` mesh axis), and hands its
parameters, inputs and outputs over in a pickle.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.runtime.pipeline import PipelinedDecoder
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.weights import params_from_jax
from test_torch_serving import _audit, _drive, _workload

N_PAGES, MP, PG = 12, 4, 4
ENGINE = dict(num_slots=4, num_stages=2, num_microbatches=2,
              prompt_capacity=16, page_size=4, num_pages=12,
              telemetry_interval=1000)
SEALED_RTOL = 1e-3      # of the largest magnitude: int8 rounding ties
LAYOUTS = [None, (3, 1), (1, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paged_inputs(cfg, seed=0):
    """Pools with random contents (page 0 null), four rows: one idle, two
    that share a prefix page for reading, each writing a private page."""
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, N_PAGES, cfg.num_kv_heads, PG, cfg.head_dim)
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    k[:, 0] = v[:, 0] = 0
    bt = np.array([[1, 2, 0, 0], [0, 0, 0, 0], [1, 3, 4, 0],
                   [5, 6, 7, 8]], np.int32)
    sl = np.array([5, 0, 9, 14], np.int32)
    tokens = rng.randint(0, cfg.vocab_size, size=(4, 1)).astype(np.int32)
    return dict(k=k, v=v, bt=bt, sl=sl, tokens=tokens)


def _cache(inp):
    return {"blocks": (torch.from_numpy(inp["k"].copy()),
                       torch.from_numpy(inp["v"].copy())),
            "block_tables": torch.from_numpy(inp["bt"].copy()),
            "seq_lens": torch.from_numpy(inp["sl"].copy())}


REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.launch.mesh import make_mesh
from repro.models.api import build_model
from repro.runtime.pipeline import PipelinedDecoder
from repro.serving import EngineConfig, ServingEngine
from repro.serving.scheduler import DONE

data = pickle.load(open(sys.argv[1], "rb"))
cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=128)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
mesh = make_mesh((2, 2), ("pod", "data"))
out = {"params": jax.tree.map(np.asarray, params), "pipe": {}, "engine": {}}

inp = data["inputs"]
with jax.set_mesh(mesh):
    for blocks in data["layouts"]:
        for seal in (True, False):
            dec = PipelinedDecoder(api, mesh, num_stages=2,
                                   num_microbatches=2, seal_boundary=seal,
                                   stage_blocks=blocks)
            step = jax.jit(dec.build(prestaged_params=True, paged=True))
            staged = dec._stage_tree((jnp.asarray(inp["k"]),
                                      jnp.asarray(inp["v"])))
            lg, (st, bt, sl) = step(
                dec.stage_params(params),
                (staged, jnp.asarray(inp["bt"]), jnp.asarray(inp["sl"])),
                {"tokens": jnp.asarray(inp["tokens"])},
                jnp.uint32(data["key"]))
            n = cfg.num_layers
            pools = tuple(np.asarray(jnp.take(
                x.reshape((-1,) + x.shape[2:]),
                jnp.asarray(dec._scatter_idx), axis=0)) for x in st)
            out["pipe"][(blocks, seal)] = (np.asarray(lg), pools,
                                           np.asarray(sl))


def drive(eng, wl):
    reqs, k, gap = [], 0, 0
    while k < len(wl) or eng.scheduler.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, gap = wl[k]
            reqs.append(eng.submit(prompt, max_new))
            k += 1
        else:
            gap -= 1
        eng.step()
        assert eng.steps < 600
    assert all(r.status == DONE for r in reqs)
    return [list(r.generated) for r in reqs]


for seal in (True, False):
    ec = EngineConfig(max_seq=128, seal_boundary=seal, **data["engine"])
    eng = ServingEngine(api, mesh=mesh, config=ec, params=params,
                        backend="pipelined")
    streams = drive(eng, data["workload"])
    out["engine"][seal] = (streams, eng.stats())
pickle.dump(out, open(sys.argv[1], "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cfg = reduced(get_arch("llama3.2-1b"))
    data = {"inputs": _paged_inputs(cfg), "layouts": LAYOUTS,
            "key": 0xC0FFEE + 3, "engine": ENGINE,
            "workload": _workload(1, 10, shared_ratio=0.5)}
    path = str(tmp_path_factory.mktemp("pipeline") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    code = REFERENCE.replace("sys.argv[1]", repr(path))
    assert "REFERENCE OK" in run_subprocess(code, devices=4, timeout=600)
    with open(path, "rb") as f:
        out = pickle.load(f)
    os.remove(path)
    tapi = build_model(cfg, device="cpu", dtype=torch.float32)
    return data, out, tapi, params_from_jax(out["params"], "cpu")


@pytest.fixture(scope="module")
def models():
    """The port's reduced llama3.2-1b, a GQA variant (2 KV heads) and
    reduced qwen2-moe-a2.7b at 4 layers (the stage layouts' depth), f32,
    with seeded random weights; the MoE's attention biases, zero at init
    as in the reference, drawn nonzero."""
    out = {}
    base = reduced(get_arch("llama3.2-1b"))
    moe = dataclasses.replace(reduced(get_arch("qwen2-moe-a2.7b")),
                              num_layers=4)
    for name, cfg in (("mha", base),
                      ("gqa", dataclasses.replace(base, num_kv_heads=2)),
                      ("moe", moe)):
        api = build_model(cfg, device="cpu", dtype=torch.float32)
        g = torch.Generator().manual_seed(1)
        params = api.init(g)
        for b in ("bq", "bk", "bv"):
            if b in params["blocks"]["attn"]:
                params["blocks"]["attn"][b].normal_(generator=g)
        out[name] = (api, params)
    return out


# ---------------------------------------------------------------------------
# (a) unsealed pipeline == the port's own decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["mha", "gqa", "moe"])
@pytest.mark.parametrize("blocks", LAYOUTS)
def test_unsealed_pipeline_equals_decode_paged_fn(models, model, blocks):
    api, params = models[model]
    inp = _paged_inputs(api.cfg, seed=2)
    want_cache = _cache(inp)
    want, _ = api.decode_paged_fn(params, want_cache,
                                  {"tokens": torch.from_numpy(inp["tokens"])})
    dec = PipelinedDecoder(api, num_stages=2, num_microbatches=2,
                           seal_boundary=False, stage_blocks=blocks)
    assert dec.stage_counts == (blocks or (2, 2))
    got_cache = _cache(inp)
    got, _ = dec.build(paged=True)(
        params, got_cache, {"tokens": torch.from_numpy(inp["tokens"])}, 7)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for g, w in zip(got_cache["blocks"], want_cache["blocks"]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    assert torch.equal(got_cache["seq_lens"], want_cache["seq_lens"])
    assert got_cache["seq_lens"].tolist() == [6, 0, 10, 15]


def test_from_spec_and_restage(models):
    from repro_torch.core.planner import profiles_from_arch
    from repro_torch.enclave.domain import two_enclave_manager
    from repro_torch.runtime.ft import OnlineReplanner
    api, _ = models["mha"]
    spec = OnlineReplanner(two_enclave_manager(),
                           profiles_from_arch(api.cfg, 1), n=10_000,
                           delta=0.5, min_stages=2).plan()
    dec = PipelinedDecoder.from_spec(api, spec, num_microbatches=2)
    assert dec.stage_counts == spec.stage_sizes() == (1, 3)
    assert dec.stage_devices == ("pod0", "pod1")
    assert dec.ranges == ((0, 1), (1, 4))
    cache = _cache(_paged_inputs(api.cfg))
    new = PipelinedDecoder(api, 2, 2, stage_blocks=(3, 1))
    assert dec.restage_cache(cache, new) is cache     # no page moves


# ---------------------------------------------------------------------------
# (b) sealed pipeline == the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocks", LAYOUTS)
@pytest.mark.parametrize("seal", [True, False])
def test_pipeline_step_matches_reference(reference, blocks, seal):
    data, out, tapi, tparams = reference
    want_lg, want_pools, want_sl = out["pipe"][(blocks, seal)]
    dec = PipelinedDecoder(tapi, num_stages=2, num_microbatches=2,
                           seal_boundary=seal, stage_blocks=blocks)
    cache = _cache(data["inputs"])
    got, _ = dec.build(paged=True)(
        tparams, cache, {"tokens": torch.from_numpy(data["inputs"]["tokens"])},
        data["key"])
    rtol = SEALED_RTOL if seal else 1e-5

    def close(g, w):
        g = g.numpy()
        assert np.abs(g - w).max() <= rtol * np.abs(w).max(), \
            np.abs(g - w).max() / np.abs(w).max()

    close(got, want_lg)
    for g, w in zip(cache["blocks"], want_pools):
        close(g, w)
    np.testing.assert_array_equal(cache["seq_lens"].numpy(), want_sl)


# ---------------------------------------------------------------------------
# (c) pipelined engine streams == the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seal", [True, False])
def test_pipelined_engine_streams_match_reference(reference, seal):
    data, out, tapi, tparams = reference
    want, jstats = out["engine"][seal]
    eng = ServingEngine(tapi, EngineConfig(seal_boundary=seal,
                                           **data["engine"]),
                        tparams, device="cpu", backend="pipelined")
    got = _drive(eng, data["workload"], audit=_audit)
    assert got == want
    st = eng.stats()
    for k in ("preemptions", "swap_outs", "swap_ins", "cow_hits", "forks",
              "completed", "tokens_out", "steps", "replans", "swaps",
              "stage_blocks", "placement", "backend"):
        assert st[k] == jstats[k], (k, st[k], jstats[k])
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0
    assert st["stage_blocks"] == (1, 3) and st["backend"] == "pipelined"


# ---------------------------------------------------------------------------
# (d) a live boundary swap keeps the streams
# ---------------------------------------------------------------------------
def test_injected_straggler_swaps_live_and_streams_stay():
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--stages", "2", "--microbatches", "2", "--slots", "4",
            "--requests", "6", "--max-new", "8", "--no-seal", "--f32",
            "--inject-straggler", "1:10", "--verify-swap"]
    st = serve.main(argv)          # asserts the streams equal (SWAP-EXACT)
    assert st["swaps"] >= 1 and st["backend"] == "pipelined"
    assert st["stage_blocks"] == (3, 1) and st["completed"] == 6


def test_non_prefix_plan_swaps_live_and_streams_stay():
    """The reference's non-prefix CI line (serve's ``--require-non-prefix``)
    through the port, less its XLA flag: the sandwich topology plans
    T|U|U, which the trusted-prefix space cannot express, and a straggler
    then moves a boundary live with the streams kept."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--mesh", "3x1",
            "--stages", "3", "--microbatches", "2", "--slots", "4",
            "--requests", "6", "--max-new", "8", "--no-seal", "--f32",
            "--topology", "sandwich", "--delta", "2.0",
            "--require-non-prefix", "--inject-straggler", "2:10",
            "--verify-swap"]
    st = serve.main(argv)      # asserts NON-PREFIX and SWAP-EXACT
    assert st["swaps"] >= 1 and st["backend"] == "pipelined"
    assert len(st["stage_blocks"]) == 3 and st["completed"] == 6
    with pytest.raises(AssertionError, match="prefix-expressible"):
        serve.main(argv[:argv.index("--topology")] + [
            "--mesh", "2x1", "--stages", "2", "--require-non-prefix"])


def test_swap_mid_stream_keeps_engine_streams(models):
    """The same workload, pipelined and unsealed: boundaries moved by hand
    twice mid-stream, under swap preemption, give the streams of a run
    that never moves them."""
    api, params = models["gqa"]
    wl = _workload(4, 8, shared_ratio=0.5)
    cfg = dict(ENGINE, seal_boundary=False)
    calm = ServingEngine(api, EngineConfig(**cfg), params, device="cpu",
                         backend="pipelined")
    moved = ServingEngine(api, EngineConfig(**cfg), params, device="cpu",
                          backend="pipelined")
    orig_step = moved.step

    def step():
        if moved.steps == 5:
            assert moved.try_swap((3, 1))
        if moved.steps == 12:
            assert moved.try_swap((2, 2))
        return orig_step()

    moved.step = step
    assert _drive(moved, wl, audit=_audit) == _drive(calm, wl)
    assert moved.swaps == 2 and moved.stage_blocks == (2, 2)
    assert [e.detail["migrated"] for e in moved.events
            if e.kind == "swap"] == [True, True]
    assert moved.stats()["swap_ins"] > 0


# ---------------------------------------------------------------------------
# (e) seals per step
# ---------------------------------------------------------------------------
@pytest.fixture
def spy(monkeypatch):
    calls = {"seal": 0, "unseal": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("S,nm,blocks", [(2, 2, (1, 3)), (4, 2, None),
                                         (4, 4, None), (1, 2, None)])
def test_seals_per_step(models, spy, S, nm, blocks):
    api, params = models["mha"]
    inp = _paged_inputs(api.cfg)
    dec = PipelinedDecoder(api, num_stages=S, num_microbatches=nm,
                           stage_blocks=blocks)
    step = dec.build(paged=True)
    cache = _cache(inp)
    for i in range(3):
        step(params, cache, {"tokens": torch.from_numpy(inp["tokens"])}, i)
        assert spy == {"seal": (i + 1) * nm * (S - 1),
                       "unseal": (i + 1) * nm * (S - 1)}


def test_engine_seals_every_boundary_of_every_step(models, spy):
    api, params = models["mha"]
    eng = ServingEngine(api, EngineConfig(**ENGINE), params, device="cpu",
                        backend="pipelined")
    _drive(eng, _workload(5, 6))
    S, nm = ENGINE["num_stages"], ENGINE["num_microbatches"]
    assert eng.steps > 0
    assert spy == {"seal": eng.steps * nm * (S - 1),
                   "unseal": eng.steps * nm * (S - 1)}
    local = ServingEngine(api, EngineConfig(**ENGINE), params, device="cpu")
    before = dict(spy)
    _drive(local, _workload(5, 6))
    assert spy == before, "the local backend seals no boundary"
