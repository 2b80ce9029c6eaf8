"""Packed prefill of the PyTorch port against the JAX package (CPU, f32),
and both prefill options on the pipelined backend.

Model function: ``prefill_packed_fn`` over K right-padded prompts (one a
dummy row of length 1) against solo ``prefill_at_fn`` calls and against
the JAX package's, logits and KV within 1e-4 (reduced llama3.2-1b, the
JAX package's f32 parameters carried across).

Engine: with ``prefill_pack`` the port's greedy streams and counters equal
the reference engine's (the packing case of the reference's
tests/test_disagg.py), on llama and on a GQA variant; on the pipelined
backend with sealed stage boundaries, chunked and packed prefill together
leave the streams of one-shot prefill unchanged through swap preemption.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serving.scheduler import DONE
from test_torch_chunked_prefill import (STATS, TOL, _assert_drained, _audit,
                                        _drive, _jax_engine, _models,
                                        _torch_engine, _workload)


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


@pytest.fixture(scope="module")
def llama(f32):
    return _models(None, 0)


@pytest.fixture(scope="module")
def gqa(f32):
    return _models(2, 1)


# ---------------------------------------------------------------------------
# model function
# ---------------------------------------------------------------------------
def test_prefill_packed_rows_equal_solo_prefill_and_reference(llama):
    japi, jparams, tapi, tparams = llama
    rng = np.random.RandomState(9)
    lens = [5, 8, 3, 1]                       # the last row: a dummy of 1
    toks = np.zeros((4, 8), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.randint(0, 512, size=n)
    tl, tc = tapi.prefill_packed_fn(tparams, {
        "tokens": torch.from_numpy(toks), "prompt_lens": np.array(lens)})
    jl, jc = japi.prefill_packed_fn(jparams, {
        "tokens": jnp.asarray(toks), "prompt_lens": jnp.asarray(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert np.isfinite(tl.numpy()).all()
    for b, n in enumerate(lens):
        sl, sc = tapi.prefill_at_fn(tparams, {
            "tokens": torch.from_numpy(toks[b:b + 1]), "prompt_len": n})
        # rows are independent: the same numbers as a solo call, up to the
        # CPU matmul's blocking for another row count
        torch.testing.assert_close(tl[b:b + 1], sl, atol=1e-5, rtol=1e-5)
        for part in range(2):
            torch.testing.assert_close(tc["blocks"][part][:, b, :, :n],
                                       sc["blocks"][part][:, 0, :, :n],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(
                tc["blocks"][part][:, b, :, :n].numpy(),
                np.asarray(jc["blocks"][part])[:, b, :, :n], **TOL)


# ---------------------------------------------------------------------------
# engine: the port's streams against the reference engine's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("models", ["llama", "gqa"])
def test_packed_prefill_streams_match_reference(request, models):
    """The reference's packing case (tests/test_disagg.py): every request
    queued before the first step, up to 4 prompts per prefill call."""
    japi, jparams, tapi, tparams = request.getfixturevalue(models)
    rng = np.random.RandomState(5)
    wl = [(rng.randint(0, 512, size=int(n)).tolist(), int(m))
          for n, m in zip(rng.randint(2, 10, size=8),
                          rng.randint(2, 7, size=8))]

    def run(eng, audit):
        reqs = [eng.submit(p, m) for p, m in wl]
        while eng.scheduler.has_work():
            eng.step()
            if audit:
                _audit(eng)
            assert eng.steps < 900
        assert all(r.status == DONE for r in reqs)
        return [r.generated for r in reqs], eng.stats()

    plain, _ = run(_torch_engine(tapi, tparams), True)
    got, ts = run(_torch_engine(tapi, tparams, prefill_pack=4), True)
    want, js = run(_jax_engine(japi, jparams, prefill_pack=4), False)
    assert got == plain == want
    assert ts["packed_admissions"] >= 4
    assert ts["packed_prefills"] < ts["packed_admissions"]
    for key in STATS:
        assert ts[key] == js[key], (key, ts[key], js[key])


# ---------------------------------------------------------------------------
# the pipelined backend, seal on
# ---------------------------------------------------------------------------
def test_pipelined_backend_chunked_and_packed_streams_unchanged(llama):
    """Both options on the pipelined backend with sealed stage boundaries,
    in a pool tight enough to swap: the streams of one-shot prefill on the
    same backend, the page ledger audited after every step."""
    _, _, tapi, tparams = llama
    wl = _workload(21, 10, tapi.cfg.vocab_size, prompt_cap=16)
    kw = dict(num_pages=12, seal_boundary=True)
    want = _drive(_torch_engine(tapi, tparams, "pipelined", **kw), wl, _audit)
    eng = _torch_engine(tapi, tparams, "pipelined", prefill_chunk=5,
                        prefill_pack=3, **kw)
    assert _drive(eng, wl, _audit) == want
    _assert_drained(eng)
    st = eng.stats()
    assert st["backend"] == "pipelined"
    assert st["chunked_admissions"] > 0 and st["packed_admissions"] > 0
