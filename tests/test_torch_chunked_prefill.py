"""Chunked and packed prefill of the PyTorch port against the JAX package
(CPU, f32).

Layers: ``chunk_prefill_attention`` (a prefix gathered from the pools plus
the chunk, causal at ``q_offset = prior_len``) against the reference's
masked attention over the whole block table — with a COW-shared page, null
table tails, garbage in the chunk's own not-yet-written pages and a prior
length that is not a multiple of the page size — within atol = rtol = 3e-5;
``paged_write_chunk`` bit for bit, sentinel rows aimed at the null page
with zeros on the device (``chunk_write_targets``) and page 0 untouched.

Model function (reduced llama3.2-1b, the JAX package's f32 parameters
carried across): a chain of ``prefill_chunk_fn`` calls against the JAX
chain, logits and pools within 1e-4.

Engine: with ``prefill_chunk`` the port's greedy streams equal the
reference engine's (the cases of the reference's
tests/test_chunked_prefill.py: chunk sizes that divide nothing, bucket and
page edges, shared prefixes, mid-prefill preemption), on llama and on a GQA
variant, with the page ledger audited after every step. Packed prefill and
the pipelined backend are in tests/test_torch_packed_prefill.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import get_arch, reduced
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.scheduler import DONE
from repro_torch.weights import params_from_jax

ATTN_TOL = dict(atol=3e-5, rtol=3e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
# the reference test's engine (tests/test_chunked_prefill.py::_engine)
ENGINE = dict(num_slots=4, num_microbatches=2, prompt_capacity=16,
              telemetry_interval=4, page_size=4)
STATS = ("chunked_admissions", "prefill_chunks", "packed_admissions",
         "packed_prefills", "preemptions", "swap_outs", "swap_ins",
         "cow_hits", "forks", "completed", "tokens_out", "steps")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fast and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32():
    """Exact token comparisons need f32 end to end (params and caches)."""
    import repro.models.layers as L
    old = L.DEFAULT_DTYPE
    L.DEFAULT_DTYPE = jnp.float32
    yield
    L.DEFAULT_DTYPE = old


def _models(kv, seed):
    from repro.models.api import build_model as jax_build
    jcfg = jax_reduced(jax_get_arch("llama3.2-1b"))
    tcfg = reduced(get_arch("llama3.2-1b"))
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=kv)
    japi = jax_build(jcfg, max_seq=128)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           japi.init(jax.random.PRNGKey(seed)))
    tapi = build_model(tcfg, device="cpu", dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return japi, jparams, tapi, tparams


@pytest.fixture(scope="module")
def llama(f32):
    return _models(None, 0)


@pytest.fixture(scope="module")
def gqa(f32):
    return _models(2, 1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _chunk_case(prior_len, C, KVH=2, rep=2, D=16, Pg=4, MP=14, N=24):
    """Pools full of noise (page 0 zero), a block table whose first page is
    shared with another row, the chunk's own pages past the prefix holding
    garbage, and a null tail."""
    rng = np.random.RandomState(prior_len * 31 + C)
    kp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    vp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    kp[0] = vp[0] = 0
    n_pages = -(-(prior_len + C) // Pg)
    bt = np.zeros((1, MP), np.int32)
    bt[0, :n_pages] = rng.permutation(np.arange(2, N))[:n_pages]
    bt[0, 0] = 1                                   # the COW-shared page
    q = rng.randn(1, C, KVH * rep, D).astype(np.float32)
    k = rng.randn(1, C, KVH, D).astype(np.float32)
    v = rng.randn(1, C, KVH, D).astype(np.float32)
    return q, k, v, kp, vp, bt


@pytest.mark.parametrize("prior_len,C", [(37, 8), (0, 5), (4, 4), (13, 3),
                                         (1, 1)])
def test_chunk_prefill_attention_matches_reference(f32, prior_len, C):
    import repro.models.layers as JL
    q, k, v, kp, vp, bt = _chunk_case(prior_len, C)
    want = np.asarray(JL.chunk_prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v, kp, vp, bt)),
        jnp.int32(prior_len)))
    got = TL.chunk_prefill_attention(
        *(torch.from_numpy(a) for a in (q, k, v, kp, vp, bt)), prior_len)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_paged_write_chunk_matches_reference_and_drops_sentinels(f32):
    import repro.models.layers as JL
    rng = np.random.RandomState(3)
    N, KVH, Pg, D, C = 10, 2, 4, 16, 8
    kp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    vp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    kp[0] = vp[0] = 0
    kn = rng.randn(C, KVH, D).astype(np.float32)
    vn = rng.randn(C, KVH, D).astype(np.float32)
    # chunk positions 5..12 of a prompt of 12: 5-7 in a shared page
    # (sentinel), 8-11 in page 3, then one of right padding (sentinel)
    pages = np.array([N, N, N, 3, 3, 3, 3, N], np.int32)
    offs = np.array([1, 2, 3, 0, 1, 2, 3, 0], np.int32)
    jk, jv = JL.paged_write_chunk(*(jnp.asarray(a) for a in
                                    (kp, vp, kn, vn, pages, offs)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    page, off, keep = TL.chunk_write_targets(torch.from_numpy(pages),
                                             torch.from_numpy(offs), N)
    assert page.tolist() == [0, 0, 0, 3, 3, 3, 3, 0]
    assert off.tolist() == [0, 0, 0, 0, 1, 2, 3, 0]
    assert keep.tolist() == [False] * 3 + [True] * 4 + [False]
    TL.paged_write_chunk(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                         (page, off, keep))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert not tk[0].any() and not tv[0].any()
    changed = {int(p) for p in np.nonzero((tk.numpy() != kp).any(
        axis=(1, 2, 3)))[0]}
    assert changed == {3}
    # an all-sentinel chunk writes nothing
    TL.paged_write_chunk(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                         TL.chunk_write_targets(torch.full((C,), N),
                                                torch.zeros(C, dtype=torch.long),
                                                N))
    assert np.array_equal(tk.numpy(), np.asarray(jk))


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------
def _chunk_chain(api, params, pools, prompt, C, Pg, pages, to_arr, N,
                 MP=8):
    """Prefill ``prompt`` into ``pages`` chunk by chunk; returns the logits
    of every chunk and the pools."""
    P = len(prompt)
    bt = np.zeros((1, MP), np.int32)
    bt[0, :len(pages)] = pages
    out = []
    for pos in range(0, P, C):
        end = min(pos + C, P)
        toks = np.zeros((1, C), np.int32)
        toks[0, :end - pos] = prompt[pos:end]
        idx = pos + np.arange(C)
        pg = np.where(idx < end, np.asarray(pages)[np.minimum(idx, P - 1)
                                                   // Pg], N).astype(np.int32)
        off = np.where(idx < end, idx % Pg, 0).astype(np.int32)
        batch = {"tokens": to_arr(toks), "offset": pos,
                 "chunk_len": end - pos, "bt_row": to_arr(bt),
                 "pages": pg, "offs": off}
        if to_arr is jnp.asarray:
            batch.update(offset=jnp.int32(pos), chunk_len=jnp.int32(end - pos),
                         pages=jnp.asarray(pg), offs=jnp.asarray(off))
        logits, pools = api.prefill_chunk_fn(params, pools, batch)
        out.append(np.asarray(logits))
    return out, pools


@pytest.mark.parametrize("C", [5, 4, 13])
def test_prefill_chunk_chain_matches_reference(llama, C):
    japi, jparams, tapi, tparams = llama
    N, Pg = 12, 4
    prompt = np.random.RandomState(C).randint(0, 512, size=13).tolist()
    pages = [3, 7, 2, 9]
    tcache = tapi.init_paged_cache(1, N, Pg, 8)
    jcache = japi.init_paged_cache(1, N, Pg, 8)
    tl, tpools = _chunk_chain(tapi, tparams, {"blocks": tcache["blocks"]},
                              prompt, C, Pg, pages, torch.from_numpy, N)
    jl, jpools = _chunk_chain(japi, jparams, {"blocks": jcache["blocks"]},
                              prompt, C, Pg, pages, jnp.asarray, N)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    for part in range(2):
        np.testing.assert_allclose(tpools["blocks"][part].numpy(),
                                   np.asarray(jpools["blocks"][part]), **TOL)
    assert not tpools["blocks"][0][:, 0].any()     # null page untouched
    # the last chunk's logits are the one-shot prefill's
    one, _ = tapi.prefill_at_fn(tparams, {
        "tokens": torch.from_numpy(np.asarray([prompt + [0, 0, 0]])),
        "prompt_len": len(prompt)})
    np.testing.assert_allclose(tl[-1], one.numpy(), **TOL)


# ---------------------------------------------------------------------------
# engine: the port's streams against the reference engine's
# ---------------------------------------------------------------------------
def _jax_engine(japi, jparams, **kw):
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    cfg = JCfg(max_seq=128, seal_boundary=False, **{**ENGINE, **kw})
    return JEngine(japi, config=cfg, params=jparams, backend="local")


def _torch_engine(tapi, tparams, backend="local", **kw):
    return ServingEngine(tapi, EngineConfig(**{**ENGINE, **kw}), tparams,
                         device="cpu", backend=backend)


def _audit(eng):
    eng.scheduler.check_invariants()
    eng.check_page_invariants()
    kp, vp = eng.backend.cache["blocks"]
    assert not kp[:, 0].any() and not vp[:, 0].any(), "null page written"


def _drive(eng, workload, audit=None):
    """The reference test's driver: submit with per-request gaps (and EOS
    ids), step to drain."""
    reqs, k, gap = [], 0, 0
    while k < len(workload) or eng.scheduler.has_work():
        if k < len(workload) and gap <= 0:
            prompt, max_new, eos, gap = workload[k]
            reqs.append(eng.submit(prompt, max_new, eos_id=eos))
            k += 1
        gap -= 1
        eng.step()
        if audit is not None:
            audit(eng)
        assert eng.steps < 1200, "schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    return [tuple(r.generated) for r in reqs]


def _workload(seed, n_req, vocab, prompt_cap):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_req):
        prompt = rng.randint(0, vocab,
                             size=int(rng.randint(2, prompt_cap))).tolist()
        max_new = int(rng.randint(1, 9))
        eos = int(rng.randint(0, vocab)) if rng.rand() < 0.5 else None
        out.append((prompt, max_new, eos, int(rng.randint(0, 3))))
    return out


def _assert_drained(eng):
    assert not eng.slot_pages and not eng.chunking
    eng.check_page_invariants()
    st = eng.stats()
    assert st["free_pages"] + len(eng.pool.prefix_index) \
        == st["num_pages"] - 1


def _both(models, wl, chunks, ref_chunks=None, **kw):
    """The reference engine and the port's, one-shot and at each chunk
    size: every port stream equal to the reference's one-shot stream; at
    the sizes in ``ref_chunks`` (default: all) the reference engine runs
    chunked too, and its streams and counters must equal the port's (the
    reference's own tests hold its chunked streams to its one-shot ones)."""
    japi, jparams, tapi, tparams = models
    want = _drive(_jax_engine(japi, jparams, **kw), wl)
    assert _drive(_torch_engine(tapi, tparams, **kw), wl, _audit) == want
    out = {}
    for C in chunks:
        te = _torch_engine(tapi, tparams, prefill_chunk=C, **kw)
        assert _drive(te, wl, _audit) == want, f"port chunk={C} diverged"
        _assert_drained(te)
        je = None
        if ref_chunks is None or C in ref_chunks:
            je = _jax_engine(japi, jparams, prefill_chunk=C, **kw)
            assert _drive(je, wl) == want, f"reference chunk={C} diverged"
            js, ts = je.stats(), te.stats()
            for key in STATS:
                assert ts[key] == js[key], (C, key, ts[key], js[key])
        out[C] = (je, te)
    return out


def test_chunked_streams_match_reference_across_chunk_sizes(llama):
    """C=1 (per token), C=3/5 (divide neither the page size 4 nor the
    prefill buckets), C=4 (page-aligned), C=16 (= prompt_capacity:
    nothing chunks)."""
    wl = _workload(7, 10, llama[2].cfg.vocab_size, prompt_cap=16)
    runs = _both(llama, wl, (1, 3, 4, 5, 16), ref_chunks=(3, 5))
    for C, (_, te) in runs.items():
        st = te.stats()
        if C < 16:
            assert st["chunked_admissions"] > 0
            assert st["prefill_chunks"] > st["chunked_admissions"]
        else:
            assert st["chunked_admissions"] == 0


def test_chunked_at_bucket_and_page_boundaries(llama):
    rng = np.random.RandomState(11)
    wl = [(rng.randint(0, 512, size=n).tolist(), 4, None, 1)
          for n in (2, 3, 4, 5, 7, 8, 9, 15, 16)]
    _both(llama, wl, (4, 5), ref_chunks=(5,))


def test_chunked_with_shared_prefixes(llama):
    """Chunk boundaries inside COW-shared prefix pages: pages are
    registered only once fully written, so later sharers still hit."""
    rng = np.random.RandomState(13)
    sys_prompt = rng.randint(0, 512, size=8).tolist()
    wl = [(sys_prompt + rng.randint(0, 512,
                                    size=int(rng.randint(0, 8))).tolist(),
           int(rng.randint(2, 7)), None, int(rng.randint(0, 2)))
          for _ in range(8)]
    runs = _both(llama, wl, (3, 4))
    for _, te in runs.values():
        assert te.pool.cow_hits > 0, "chunking must not defeat COW sharing"


def test_chunked_mid_prefill_preemption(llama):
    """An older request's decode growth exhausts a 6-page pool while a
    younger 15-token prompt is mid-prefill in chunks of 3: the prefilling
    slot is preempted (recompute, never swap) and restarts; streams and
    the preemption events equal the reference engine's."""
    rng = np.random.RandomState(17)
    wl = [(rng.randint(0, 512, size=4).tolist(), 16, None, 0),
          (rng.randint(0, 512, size=15).tolist(), 2, None, 0)]
    runs = _both(llama, wl, (3,), request_capacity=24, num_pages=7)
    je, te = runs[3]
    mid = [e.detail for e in te.events
           if e.kind == "preempt" and e.detail.get("mid_prefill")]
    assert mid, "expected a mid-prefill preemption"
    assert all(0 <= d["prefilled"] < 15 for d in mid)
    assert mid == [e.detail for e in je.events
                   if e.kind == "preempt" and e.detail.get("mid_prefill")]


def test_gqa_chunked_streams_match_reference(gqa):
    """GQA (2 KV heads for 4 query heads): grouped prefill attention over a
    gathered prefix, in a pool tight enough to swap-preempt."""
    wl = _workload(3, 10, gqa[2].cfg.vocab_size, prompt_cap=16)
    runs = _both(gqa, wl, (3,), num_pages=12)
    assert runs[3][1].stats()["chunked_admissions"] > 0
