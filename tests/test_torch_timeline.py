"""The timeline KV layout, per-token prefill and the int8 KV cache of the
PyTorch port against the JAX package, on the CPU at reduced width.

(a) ``layers.decode_attention`` with a per-row ``start`` and with
    ``rolling`` equals the reference's within f32 allclose (1e-5).
(b) ``prefill_fn`` and ``decode_fn`` from one cache in both packages
    (``weights.cache_from_jax``): logits, caches, ``len`` and ``start``,
    f32 and bf16 and the int8 cache. Tolerances, of the largest |value|:
    f32 logits 1e-4 and K/V 1e-5; bf16 logits and K/V 5e-2 (XLA and
    PyTorch round bf16 products and sums at different points: about 13
    bf16 ulps at 1.0 after four layers); int8 payloads equal but for +-1
    where a
    rounding tie lands on the other side (at most 1% of the written
    elements), scales within 1e-5 relative.
(c) Engines at the reference's seeds (``tests/test_paged.py``,
    ``tests/test_serving.py``, ``tests/test_aot_warmup.py``,
    ``tests/test_disagg.py``, ``tests/test_perf_features.py``): the
    timeline, paged per-token and paged batched streams equal each other
    and the reference's timeline streams; per-token prefill takes one call
    a token; the horizon back-pressures; the pipelined timeline equals the
    local one and the reference's, across a live swap; a warmed timeline
    engine captures nothing while serving; the layout and model refusals
    name the layout or the model; the int8-cache engine's streams equal
    the reference's (which quantizes against the zero scales of
    ``init_cache``: see ROADMAP.md, section 3); reduced qwen2-moe on the
    timeline equals the reference's.
(d) serve's ``--kv-layout``, ``--max-seq`` and ``--per-token-prefill``.
(e) On the card (marked ``cuda``): a warmed timeline engine's streams and
    caches equal the eager engine's bit for bit.

JAX is imported where a test needs it, so that the card's tests run on a
host without it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.models.transformer import (SEGMENT, dequantize_kv,
                                            quantize_kv)
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.scheduler import DONE
from repro_torch.weights import cache_from_jax, params_from_jax

# the reference tests' engine (tests/test_paged.py::_engine)
ENGINE = dict(num_slots=4, num_microbatches=2, max_seq=128,
              prompt_capacity=16, telemetry_interval=4, seal_boundary=False,
              page_size=4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
F32_TOL = 1e-4           # of the largest |logit|
BF16_TOL = 5e-2
TIE_SHARE = 0.01         # int8 payload elements off by one, of those written


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread runs them faster and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """(jax, jax.numpy), or a skip on a host without JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(scope="module")
def f32():
    _, jnp = _jax()
    import repro.models.layers as JL
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    yield
    JL.DEFAULT_DTYPE = old


def _pair(arch="llama3.2-1b", quant=False, max_seq=128, seed=0,
          dtype=torch.float32):
    """(japi, jparams, tapi, tparams): reduced ``arch``, the JAX package's
    parameters carried across."""
    jax, jnp = _jax()
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.models.api import build_model as jax_build
    japi = jax_build(jax_reduced(jax_get_arch(arch)), max_seq=max_seq,
                     cache_quant=quant)
    jparams = japi.init(jax.random.PRNGKey(seed))
    if dtype == torch.float32:
        jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    tapi = build_model(reduced(get_arch(arch)), device="cpu", dtype=dtype,
                       max_seq=max_seq, cache_quant=quant)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return japi, jparams, tapi, tparams


@pytest.fixture(scope="module")
def llama(f32):
    return _pair()


@pytest.fixture(scope="module")
def llama_q8(f32):
    return _pair(quant=True)


def _jengine(japi, jparams, backend="local", **kw):
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    return JEngine(japi, config=JCfg(**{**ENGINE, **kw}), params=jparams,
                   backend=backend)


def _engine(tapi, tparams, backend="local", **kw):
    return ServingEngine(tapi, EngineConfig(**{**ENGINE, **kw}), tparams,
                         device="cpu", backend=backend)


def _drive(eng, wl):
    """The reference's ``tests/test_paged.py::_drive``: submit with arrival
    gaps, step to drain, every request done."""
    reqs, k, gap = [], 0, 0
    while k < len(wl) or eng.scheduler.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, eos, gap = wl[k]
            reqs.append(eng.submit(prompt, max_new, eos_id=eos))
            k += 1
        gap -= 1
        eng.step()
        assert eng.steps < 600, "schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    return [list(r.generated) for r in reqs]


def _workload(seed, n_req, vocab, prompt_cap):
    """The reference's ``tests/test_paged.py::_workload`` (same draws):
    (prompt, max_new, eos or None, arrival gap) per request."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_req):
        prompt = rng.randint(0, vocab,
                             size=int(rng.randint(2, prompt_cap))).tolist()
        max_new = int(rng.randint(1, 9))
        eos = int(rng.randint(0, vocab)) if rng.rand() < 0.5 else None
        out.append((prompt, max_new, eos, int(rng.randint(0, 3))))
    return out


# ---------------------------------------------------------------------------
# (a) decode_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rolling,start", [(False, None), (False, "rows"),
                                           (True, None), (True, "rows"),
                                           (False, "one")])
def test_decode_attention_matches_reference(rolling, start):
    _, jnp = _jax()
    from repro.models.layers import decode_attention as jax_attention
    rng = np.random.RandomState(3)
    B, H, KVH, S, D = 3, 8, 2, 12, 16
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k = rng.randn(B, KVH, S, D).astype(np.float32)
    v = rng.randn(B, KVH, S, D).astype(np.float32)
    for n in (5, 12, 17):             # within, at and (rolling) past S
        st = {None: None, "rows": np.array([0, 2, n - 1], np.int32),
              "one": np.array([1], np.int32)}[start]
        want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(n), rolling=rolling,
                             start=None if st is None else jnp.asarray(st))
        got = L.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(n, dtype=torch.int32), rolling=rolling,
            start=None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATTN_TOL)


# ---------------------------------------------------------------------------
# (b) prefill_fn and decode_fn from one state
# ---------------------------------------------------------------------------
def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max()


def _payload_ties(got, want, written):
    """int8 payloads: equal but for +-1 ties, at most TIE_SHARE of the
    ``written`` elements."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).sum() <= max(1, TIE_SHARE * written), (d > 0).sum()


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _padded(cache, n: int):
    """The reference test's pad: ``n`` free positions on every 5-D leaf."""
    _, jnp = _jax()
    return {k: (tuple(jnp.pad(a, [(0, 0)] * 3 + [(0, n), (0, 0)])
                      if a.ndim == 5 else a for a in v)
                if k != "len" else v) for k, v in cache.items()}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_prefill_then_decode_matches_reference(kind, f32):
    jax, jnp = _jax()
    quant = kind == "int8"
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    if kind == "bf16":
        import repro.models.layers as JL
        JL.DEFAULT_DTYPE = jnp.bfloat16
    try:
        japi, jparams, tapi, tparams = _pair(quant=quant, max_seq=32,
                                             dtype=dtype)
        cfg = tapi.cfg
        tol = BF16_TOL if kind == "bf16" else F32_TOL
        rng = np.random.RandomState(1)
        toks = rng.randint(0, cfg.vocab_size, (4, 11)).astype(np.int32)
        jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks)})
        tl, tc = tapi.prefill_fn(tparams,
                                 {"tokens": torch.from_numpy(toks).long()})
        _close(_to_np(tl), jl, tol)
        assert int(tc["len"]) == int(jc["len"]) == 11
        for got, want in zip(tc[SEGMENT], jc["blocks"]):
            if got.dtype == torch.int8:
                _payload_ties(got.numpy(), want, want.size)
            else:
                _close(_to_np(got), want, 1e-5 if kind != "bf16" else tol)
        # decode twice from the reference's cache, with per-row starts
        jcache = _padded(jc, 2)
        jcache["start"] = jnp.asarray(np.array([0, 3, 10, 0], np.int32))
        tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
        for step in range(2):
            new = rng.randint(0, cfg.vocab_size, (4, 1)).astype(np.int32)
            jl, jcache = japi.decode_fn(jparams, jcache,
                                        {"tokens": jnp.asarray(new)})
            tl, tcache = tapi.decode_fn(tparams, tcache,
                                        {"tokens": torch.from_numpy(new)})
            _close(_to_np(tl), jl, tol)
            assert int(tcache["len"]) == int(jcache["len"]) == 12 + step
            assert np.array_equal(tcache["start"].numpy(),
                                  np.asarray(jcache["start"]))
            for got, want in zip(tcache[SEGMENT], jcache["blocks"]):
                want = np.asarray(want)
                if got.dtype == torch.int8:
                    # written: one position per (layer, row, head, channel)
                    _payload_ties(got.numpy(), want,
                                  want.size // want.shape[3])
                elif got.dim() == 3:
                    assert np.array_equal(got.numpy(), want)  # scales
                else:
                    _close(_to_np(got), want, 1e-5 if kind != "bf16"
                           else tol)
    finally:
        if kind == "bf16":
            import repro.models.layers as JL
            JL.DEFAULT_DTYPE = jnp.float32


def test_int8_cache_roundtrip_bounded():
    """The reference's ``test_int8_cache_roundtrip_bounded`` on the port's
    ``quantize_kv`` / ``dequantize_kv``, and equal payloads to the
    reference's on the same data."""
    _, jnp = _jax()
    from repro.models.transformer import quantize_kv as jax_quantize
    k = np.random.RandomState(0).randn(2, 4, 16, 8).astype(np.float32)
    scale = np.abs(k).max(axis=(0, 2)) / 127.0 + 1e-6
    q = quantize_kv(torch.from_numpy(k), torch.from_numpy(scale)[:, None, :])
    back = dequantize_kv(q, torch.from_numpy(scale)[:, None, :])
    assert q.dtype == torch.int8
    assert float((back - torch.from_numpy(k)).abs().max()
                 / (np.abs(k).max() + 1e-9)) < 0.02
    assert np.array_equal(q.numpy(), np.asarray(jax_quantize(
        jnp.asarray(k), jnp.asarray(scale)[:, None, :])))


def test_int8_cache_decode_top1_agrees(f32):
    """The reference's ``test_int8_cache_decode_top1_agrees`` on the port:
    prefill 4 x 31 tokens then decode one, int8 against f32 caches."""
    cfg = reduced(get_arch("llama3.2-1b"))
    api_f = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=32)
    api_q = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=32,
                        cache_quant=True)
    params = api_f.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 31), generator=g)
    new = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
    out = []
    for api in (api_f, api_q):
        _, c = api.prefill_fn(params, {"tokens": toks})
        c[SEGMENT] = tuple(torch.nn.functional.pad(a, (0, 0, 0, 1))
                           if a.dim() == 5 else a for a in c[SEGMENT])
        out.append(api.decode_fn(params, c, {"tokens": new})[0].numpy())
    a, b = out
    assert (a.argmax(-1) == b.argmax(-1)).all()
    assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 0.15


def test_int8_decode_error_equals_reference_at_full_width():
    """The same comparison at llama3.2-1b's full width (d_model 2048, 32
    heads over 8, d_ff 8192) cut to one layer and a vocabulary of 8192,
    bf16, the reference test's seeds: the port's int8 decode error equals
    the reference's (within 0.01 of the largest |logit|), and both exceed
    the 0.15 that the reference's test holds at its reduced width, so that
    bound is a property of the reduced config, not of the int8 scheme at
    full width."""
    jax, jnp = _jax()
    import dataclasses
    from repro.configs import get_arch as jax_get_arch
    from repro.models.api import build_model as jax_build
    jcfg = dataclasses.replace(jax_get_arch("llama3.2-1b"), num_layers=1,
                               vocab_size=8192)
    tcfg = dataclasses.replace(get_arch("llama3.2-1b"), num_layers=1,
                               vocab_size=8192)
    jparams = jax_build(jcfg, 32).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 31), 0,
                              jcfg.vocab_size, jnp.int32)
    new = jax.random.randint(jax.random.PRNGKey(2), (4, 1), 0,
                             jcfg.vocab_size, jnp.int32)
    jout, tout = [], []
    for quant in (False, True):
        japi = jax_build(jcfg, 32, cache_quant=quant)
        _, c = japi.prefill_fn(jparams, {"tokens": toks})
        jout.append(np.asarray(japi.decode_fn(
            jparams, _padded(c, 1), {"tokens": new})[0], np.float32))
        tapi = build_model(tcfg, device="cpu", max_seq=32,
                           cache_quant=quant)
        _, c = tapi.prefill_fn(tparams, {"tokens": torch.from_numpy(
            np.array(toks)).long()})
        c[SEGMENT] = tuple(torch.nn.functional.pad(a, (0, 0, 0, 1))
                           if a.dim() == 5 else a for a in c[SEGMENT])
        tout.append(tapi.decode_fn(tparams, c, {"tokens": torch.from_numpy(
            np.array(new)).long()})[0].float().numpy())
    rel = [np.abs(a - b).max() / np.abs(a).max() for a, b in (jout, tout)]
    assert abs(rel[0] - rel[1]) < 0.01, rel
    assert min(rel) > 0.15, rel
    assert (jout[0].argmax(-1) == jout[1].argmax(-1)).sum() == \
        (tout[0].argmax(-1) == tout[1].argmax(-1)).sum()


def test_int8_cache_shrinks_cache_specs():
    """The reference's ``test_int8_cache_shrinks_cache_specs``: full-width
    command-r-35b at 1024 positions, specs only (nothing allocated)."""
    cfg = get_arch("command-r-35b")
    sizes = []
    for quant in (False, True):
        api = build_model(cfg, device="cpu", max_seq=1024,
                          cache_quant=quant)
        specs = api.init_cache_specs(4)
        sizes.append(sum(int(np.prod(shape)) * torch.empty(
            (), dtype=dt).element_size() for shape, dt in specs[SEGMENT]))
        assert specs["len"] == ((), torch.int32)
        assert api.paged_ok == (not quant)
    assert sizes[1] < 0.55 * sizes[0]


# ---------------------------------------------------------------------------
# (c) engines
# ---------------------------------------------------------------------------
def test_timeline_paged_pertoken_streams_equal_reference(llama):
    """``tests/test_paged.py::test_paged_token_equal_to_timeline_randomized``
    on the port, and its streams equal to the reference's timeline."""
    japi, jparams, tapi, tparams = llama
    for seed in (0, 1):
        wl = _workload(seed, 10, tapi.cfg.vocab_size, 12)
        want = _drive(_jengine(japi, jparams, kv_layout="timeline"), wl)
        for kw in (dict(kv_layout="timeline"), dict(),
                   dict(batched_prefill=False),
                   dict(num_pages=19, request_capacity=24)):
            eng = _engine(tapi, tparams, **kw)
            assert _drive(eng, wl) == want, (seed, kw)
            assert eng.kv_layout == kw.get("kv_layout", "paged")
            eng.check_page_invariants()


def test_batched_prefill_one_call_pertoken_one_a_token(llama):
    """``tests/test_paged.py::test_batched_prefill_64_token_prompt_single
    _call``: a 64-token prompt admits in one call or in 64, same stream,
    the reference's stream."""
    japi, jparams, tapi, tparams = llama
    prompt = np.random.RandomState(4).randint(
        0, tapi.cfg.vocab_size, size=64).tolist()
    out = {}
    for batched in (True, False):
        eng = _engine(tapi, tparams, prompt_capacity=64,
                      request_capacity=80, batched_prefill=batched)
        req = eng.submit(prompt, 6)
        eng.run(max_steps=50)
        assert req.status == DONE
        out[batched] = (eng.prefill_calls, req.generated)
    jeng = _jengine(japi, jparams, prompt_capacity=64, request_capacity=80,
                    batched_prefill=False)
    jreq = jeng.submit(prompt, 6)
    jeng.run(max_steps=50)
    assert out[True][0] == 1 and out[False][0] == 64 == jeng.prefill_calls
    assert out[True][1] == out[False][1] == list(jreq.generated)


@pytest.mark.parametrize("per_slot_start", [True, False])
def test_pipelined_decoder_timeline_equals_decode_fn(llama, per_slot_start):
    """``PipelinedDecoder.build(paged=False)`` at uneven blocks (1, 3) and
    two microbatches, unsealed, from one cache: the logits, the body and
    ``len`` equal ``decode_fn``'s, with and without per-slot starts; the
    staging round-trips and a restage onto other blocks moves nothing."""
    from repro_torch.runtime.pipeline import PipelinedDecoder
    _, _, tapi, tparams = llama
    rng = np.random.RandomState(5)
    cache = tapi.init_cache(4, 16, fill_len=9)
    cache[SEGMENT] = tuple(torch.from_numpy(rng.randn(*t.shape).astype(
        np.float32)) for t in cache[SEGMENT])
    if per_slot_start:
        cache["start"] = torch.tensor([0, 3, 8, 9], dtype=torch.int32)
    toks = torch.from_numpy(rng.randint(0, tapi.cfg.vocab_size, (4, 1)))
    dec = PipelinedDecoder(tapi, num_stages=2, num_microbatches=2,
                           seal_boundary=False, stage_blocks=(1, 3))
    body, n = dec.stage_cache(cache)
    back = dec.unstage_cache(body, n)
    assert back[SEGMENT] is cache[SEGMENT] and back["len"] is cache["len"]
    staged = (tuple(t.clone() for t in body), n.clone())
    if per_slot_start:
        staged += (cache["start"],)
    other = PipelinedDecoder(tapi, num_stages=2, num_microbatches=2,
                             seal_boundary=False, stage_blocks=(3, 1))
    assert dec.restage_cache(staged, other) is staged
    got, staged = dec.build(paged=False, per_slot_start=per_slot_start)(
        tparams, staged, {"tokens": toks}, 0)
    want, cache = tapi.decode_fn(tparams, cache, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert int(staged[1]) == int(cache["len"]) == 10
    for a, b in zip(staged[0], cache[SEGMENT]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_timeline_horizon_backpressure(llama):
    """``tests/test_serving.py::test_engine_timeline_horizon_backpressure``:
    a request whose worst case cannot fit waits; a permanently blocked
    head stalls the engine gracefully."""
    _, _, tapi, tparams = llama
    eng = _engine(tapi, tparams, max_seq=32, prompt_capacity=8,
                  kv_layout="timeline")
    fits = eng.submit([1, 2, 3], max_new_tokens=4)
    never = eng.submit([1, 2, 3], max_new_tokens=1000)   # > horizon forever
    eng.run(max_steps=100)
    assert fits.status == DONE and never.status == "queued"
    assert eng.stalled and eng.stats()["stall_reason"] == "permanent"
    assert any(e.kind == "backpressure" and e.detail["waiting_on"] ==
               "timeline" for e in eng.events)
    before = eng.steps
    eng.step()
    assert eng.steps == before and eng.stalled


def _pipe_run(tapi, tparams, backend, inject, **kw):
    """``tests/test_serving.py``'s ENGINE_PIPE_CODE stream."""
    eng = _engine(tapi, tparams, backend=backend, kv_layout="timeline", **kw)
    if inject:
        eng.telemetry.inject(1, 25.0)
    rng = np.random.RandomState(3)
    reqs = [eng.submit(rng.randint(0, tapi.cfg.vocab_size,
                                   size=int(rng.randint(3, 9))).tolist(), 10)
            for _ in range(5)]
    eng.run(max_steps=120)
    assert all(r.status == DONE for r in reqs)
    return eng, [list(r.generated) for r in reqs]


def test_pipelined_timeline_equals_local_and_reference(llama):
    """``tests/test_serving.py::test_engine_pipelined_matches_local`` and
    ``..._live_swap_token_exact`` on the timeline: the pipelined backend
    (undisturbed, and with a straggler that forces a live swap) gives the
    local backend's streams, which are the reference's."""
    japi, jparams, tapi, tparams = llama
    _, local = _pipe_run(tapi, tparams, "local", False)
    jeng = _jengine(japi, jparams, kv_layout="timeline")
    rng = np.random.RandomState(3)
    jreqs = [jeng.submit(rng.randint(0, tapi.cfg.vocab_size,
                                     size=int(rng.randint(3, 9))).tolist(),
                         10) for _ in range(5)]
    jeng.run(max_steps=120)
    assert local == [list(r.generated) for r in jreqs]
    calm, calm_streams = _pipe_run(tapi, tparams, "pipelined", False)
    assert calm.stats()["kv_layout"] == "timeline" and calm_streams == local
    swapped, swap_streams = _pipe_run(tapi, tparams, "pipelined", True)
    assert swapped.swaps >= 1
    assert any(e.kind == "swap" and e.detail["migrated"]
               for e in swapped.events)
    assert swapped.stage_blocks != calm.stage_blocks
    assert swap_streams == local


def test_warmed_timeline_engine_zero_compiles(llama):
    """``tests/test_aot_warmup.py::test_warmed_timeline_engine_zero
    _compiles``, local and pipelined: warmed streams equal cold ones (and
    the reference's) and nothing new is entered after warmup."""
    japi, jparams, tapi, tparams = llama
    wl = _workload(31, 6, tapi.cfg.vocab_size, 8)
    want = _drive(_jengine(japi, jparams, kv_layout="timeline", max_seq=256),
                  wl)
    for backend, kw in (("local", dict(allow_swap=False)),
                        ("pipelined", dict())):
        cold = _engine(tapi, tparams, backend, kv_layout="timeline",
                       max_seq=256, **kw)
        eng = _engine(tapi, tparams, backend, kv_layout="timeline",
                      max_seq=256, warmup=True, **kw)
        assert _drive(cold, wl) == _drive(eng, wl) == want, backend
        st = eng.stats()
        assert st["warmed"] and st["post_warmup_compiles"] == 0
        assert st["compile_stalls"] == []
        assert st["global_len"] == cold.stats()["global_len"]
        for name in ("decode_step" if backend == "local"
                     else f"step{eng.stage_blocks}", "prefill_token",
                     "insert"):
            assert eng.aot.fns[name].signatures, name


def test_timeline_layout_rejects_swap_and_disagg(llama, llama_q8):
    """``tests/test_disagg.py``'s config-time refusals and the ``auto``
    policy, on the port: the timeline layout is named, and a quantized
    model by its name."""
    _, _, tapi, tparams = llama
    with pytest.raises(ValueError, match="timeline"):
        _engine(tapi, tparams, kv_layout="timeline", preempt_policy="swap")
    with pytest.raises(ValueError, match="timeline"):
        _engine(tapi, tparams, kv_layout="timeline", disagg_role="decode")
    with pytest.raises(ValueError, match="kv_layout"):
        _engine(tapi, tparams, kv_layout="ring")
    assert _engine(tapi, tparams).preempt_policy == "swap"
    assert _engine(tapi, tparams, kv_layout="timeline").stats()[
        "preempt_policy"] == "recompute"
    _, _, qapi, qparams = llama_q8
    assert not qapi.paged_ok
    with pytest.raises(ValueError, match=qapi.cfg.name):
        _engine(qapi, qparams, preempt_policy="swap")
    with pytest.raises(ValueError, match=qapi.cfg.name):
        _engine(qapi, qparams, disagg_role="prefill")
    eng = _engine(qapi, qparams)
    assert eng.kv_layout == "timeline" and eng.preempt_policy == "recompute"


def test_quantized_engine_streams_equal_reference(llama_q8):
    """An int8-cache model serves on the timeline. Its per-token prefill
    starts from a zero cache, scales included, and nothing sets them (only
    the whole-batch ``prefill_fn`` does), so every K/V is quantized against
    a scale of 0 and dequantizes to 0, in the reference as in the port:
    the streams are equal, and the scales stay 0."""
    japi, jparams, tapi, tparams = llama_q8
    wl = _workload(0, 8, tapi.cfg.vocab_size, 12)
    want = _drive(_jengine(japi, jparams), wl)
    for backend in ("local", "pipelined"):
        eng = _engine(tapi, tparams, backend)
        assert _drive(eng, wl) == want, backend
        k_q, v_q, k_s, v_s = eng.backend.cache[SEGMENT]
        assert k_q.dtype == torch.int8 and not k_s.any() and not v_s.any()
        assert int((k_q.abs() == 127).sum()) > 0


def test_chaos_timeline_equals_reference(llama, monkeypatch):
    """The fault plane on a timeline engine, as the reference's plane runs
    there: stalls and device deaths draw at the telemetry ticks, a death
    re-plans around the corpse and spills nothing (there is no page
    pool), and nothing storms or tampers. Equal streams (to the reference
    and to the port's fault-free run), injected faults, recovery rungs,
    failure re-plans and fault events; one step clock for both packages'
    engines (``tests/test_torch_faults.py``), so re-plans depend on the
    step count alone."""
    import repro.serving.engine as jengine
    import repro_torch.serving.engine as tengine
    from repro.serving.faults import FaultConfig as JFaultConfig
    from repro_torch.serving import FaultConfig
    from test_torch_faults import _StepClock
    clock = _StepClock()
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod, "time", clock)
    japi, jparams, tapi, tparams = llama
    wl = _workload(3, 8, tapi.cfg.vocab_size, 12)
    kw = dict(seed=4, stage_stall=0.5, device_death=0.5)
    jeng = _jengine(japi, jparams, kv_layout="timeline",
                    faults=JFaultConfig.chaos(**kw))
    want = _drive(jeng, wl)
    eng = _engine(tapi, tparams, kv_layout="timeline",
                  faults=FaultConfig.chaos(**kw))
    assert _drive(eng, wl) == want == _drive(
        _engine(tapi, tparams, kv_layout="timeline"), wl)
    st, jst = eng.stats(), jeng.stats()
    for k in ("faults", "recovery", "faults_pending", "failure_replans",
              "replans", "excluded_devices"):
        assert st[k] == jst[k], (k, st[k], jst[k])
    assert st["faults"]["device_death"] == 1
    assert st["faults"]["stage_stall"] > 0
    assert st["recovery"]["device_loss_spills"] == 0

    def events(e):
        return [(ev.step, ev.kind, ev.detail) for ev in e.events
                if ev.kind.startswith("fault_") or ev.kind == "replan"]
    assert events(eng) == events(jeng)


def test_moe_timeline_equals_reference(f32):
    """Reduced qwen2-moe (MoE FFN, attention biases drawn nonzero) on the
    timeline, local backend, against the reference's."""
    from test_torch_configs import _models
    japi, jparams, tapi, tparams = _models("qwen2-moe-a2.7b")
    wl = _workload(2, 6, tapi.cfg.vocab_size, 12)
    want = _drive(_jengine(japi, jparams, kv_layout="timeline"), wl)
    assert _drive(_engine(tapi, tparams, kv_layout="timeline"), wl) == want


# ---------------------------------------------------------------------------
# (d) serve's flags
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ["--kv-layout", "timeline"],
    ["--kv-layout", "timeline", "--max-seq", "40", "--stages", "2",
     "--backend", "pipelined", "--warmup", "--assert-no-recompile"],
    ["--per-token-prefill", "--warmup", "--assert-no-recompile"]])
def test_serve_layout_flags_on_cpu(flags):
    st = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--backend", "local", "--slots", "4", "--requests", "5",
                     "--prompt-len", "8", "--max-new", "5", "--f32",
                     *flags])
    assert st["completed"] == 5 and st["tokens_out"] == 25
    layout = "timeline" if "timeline" in flags else "paged"
    assert st["kv_layout"] == layout
    assert st["batched_prefill"] == ("--per-token-prefill" not in flags)
    if "--max-seq" in flags:
        assert st["max_seq"] == 40 and st["backend"] == "pipelined"
    # every case prefills a token a call
    assert st["prefill_calls"] > st["admissions"] == 5


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["local", "pipelined"])
def test_timeline_graphs_equal_eager_on_the_card(cuda, backend):
    """Same parameters, same stream: a timeline engine replaying CUDA
    graphs (decode step, per-token prefill, insert) serves the eager
    engine's streams and ends with its cache, bit for bit."""
    api = build_model(reduced(get_arch("llama3.2-1b")), device=cuda,
                      dtype=torch.float32)
    params = api.init(torch.Generator(device=cuda).manual_seed(0))
    wl = _workload(5, 10, api.cfg.vocab_size, 12)
    runs = []
    for warm in (False, True):
        eng = ServingEngine(api, EngineConfig(
            **{**ENGINE, "kv_layout": "timeline", "warmup": warm,
               "allow_swap": False}), params, device=cuda, backend=backend)
        streams = _drive(eng, wl)
        runs.append((streams, [t.clone() for t in
                               eng.backend.cache[SEGMENT]]))
        if warm:
            assert eng.stats()["post_warmup_compiles"] == 0
    (a, ca), (b, cb) = runs
    assert a == b
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
