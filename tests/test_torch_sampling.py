"""Sampling at temperature > 0 in the PyTorch port (CPU), against
``jax.random`` and the JAX package's sampler and engine.

* JAX's keyed randomness, stage by stage: ``PRNGKey``, threefry-2x32,
  ``fold_in`` and 32-bit ``random_bits`` (partitionable layout) and
  ``uniform`` bit for bit; each of the gumbel's two ``log``s within 1 ulp
  of XLA's on the same input, the composed gumbel within 2 ulp of 1 or of
  the value, whichever is larger (an ulp of the inner log is a relative
  error of 2^-24 in ``t``, an absolute one in ``-log t``); categorical
  draws, and so tokens, equal.
* ``TokenSampler`` token for token against the reference's, on the
  reference's own cases (tests/test_serving.py) and on random logits at
  several seeds, temperatures and ``top_k`` (ties at the k-th logit kept).
* Sampled engine streams equal the reference engine's on the same f32
  parameters (reduced llama3.2-1b drawn by JAX), under swap preemption;
  temperature 0 with ``top_k`` equals greedy; inside the port, chunked =
  one-shot, disaggregated = monolithic, warmed = cold and swap =
  recompute = undisturbed under sampling, and the pair refuses a sampler
  mismatch on each field.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.serving.sampling import TokenSampler as JaxSampler
from repro_torch.serving import (DisaggOrchestrator, EngineConfig,
                                 PrefillEngine, ServingEngine, build_disagg)
from repro_torch.serving import sampling as S
from repro_torch.serving.sampling import TokenSampler
from test_torch_disagg import _drive_orch
from test_torch_engine import _both, _jax_engine, models  # noqa: F401
from test_torch_serving import BASE, _audit, _drive, _torch_engine, _workload

SAMPLED = dict(temperature=0.8, sample_seed=11)
TINY = np.finfo(np.float32).tiny


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


def _ulps(a, b):
    """Distance in f32 units in the last place (finite, same sign)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# jax.random, stage by stage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 11, 2**31 - 1, -1, 2**33 + 3])
def test_prng_key_matches_jax(seed):
    assert S.prng_key(seed) == _words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("n", [2, 5, 64])
def test_threefry2x32_matches_jax(n):
    """``jprng.threefry_2x32`` splits the counts into halves (padding an
    odd count with a zero) and hashes the two halves as the word pair."""
    rng = np.random.RandomState(n)
    for _ in range(4):
        key = rng.randint(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
        cnt = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                              jnp.asarray(cnt)))
        c = torch.from_numpy(np.concatenate([cnt, np.zeros(n % 2, np.uint32)])
                             .astype(np.int64))
        h = c.numel() // 2
        y0, y1 = S.threefry2x32(int(key[0]), int(key[1]), c[:h], c[h:])
        got = torch.cat([y0, y1])[:n].numpy()
        assert np.array_equal(got, want.astype(np.int64))


def test_fold_in_matches_jax():
    data = [0, 1, 5, 123456789, 2**31, 2**32 - 1]
    for seed in (0, 11, 3):
        k1, k2 = S.fold_in(*S.prng_key(seed), torch.tensor(data))
        for i, d in enumerate(data):
            want = _words(jax.random.fold_in(jax.random.PRNGKey(seed), d))
            assert (int(k1[i]), int(k2[i])) == want, (seed, d)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 512, 128_256])
def test_bits_uniform_gumbel_categorical_match_jax(n):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 5), 7)
    k1, k2 = _words(key)
    bits = S.random_bits(k1, k2, n)
    want_bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    assert np.array_equal(bits.numpy(), want_bits.astype(np.int64))
    u = S.uniform(bits).numpy()
    want_u = np.asarray(jax.random.uniform(key, (n,), jnp.float32,
                                           minval=TINY, maxval=1.0))
    assert np.array_equal(u, want_u)
    # each log within 1 ulp of XLA's on the same input
    t = torch.from_numpy(u).log().neg()
    jt = -np.asarray(jnp.log(jnp.asarray(u)))
    assert _ulps(t.numpy(), jt).max() <= 1
    assert _ulps(torch.from_numpy(jt).log().numpy(),
                 np.asarray(jnp.log(jnp.asarray(jt)))).max() <= 1
    g = S.gumbel(k1, k2, (n,)).numpy()
    want_g = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
    ulp = np.spacing(np.maximum(np.abs(want_g), np.float32(1)))
    assert (np.abs(g - want_g) <= 2 * ulp).all()
    logits = np.random.RandomState(n).randn(n).astype(np.float32) * 3
    assert int(S.categorical(k1, k2, torch.from_numpy(logits))) == \
        int(jax.random.categorical(key, jnp.asarray(logits)))


# ---------------------------------------------------------------------------
# TokenSampler against the reference's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_sampler(*args):
    """One reference sampler per config: each jits its own functions."""
    return JaxSampler(*args)


def _both_samplers(logits, rids, idxs, *args):
    want = _jax_sampler(*args).sample(jnp.asarray(logits), rids, idxs)
    got = TokenSampler(*args).sample(torch.from_numpy(logits), rids, idxs)
    assert got.dtype == np.int32
    assert got.tolist() == np.asarray(want).tolist(), (args, got, want)
    return got


def test_sampler_temperature_zero_is_argmax():
    logits = np.random.RandomState(0).randn(4, 32).astype(np.float32)
    s = TokenSampler(temperature=0.0)
    assert s.greedy
    got = s.sample(torch.from_numpy(logits), np.arange(4), np.zeros(4))
    assert got.tolist() == logits.argmax(-1).tolist()
    _both_samplers(logits, np.arange(4), np.zeros(4, np.int64), 0.0)


def test_sampler_key_threading_is_slot_independent():
    """The reference's case: a request's sample depends only on (seed, rid,
    token index), not on its row or its batch-mates; equal to the
    reference's draws."""
    rng = np.random.RandomState(1)
    row = rng.randn(1, 64).astype(np.float32)
    alone = _both_samplers(row, np.asarray([5]), np.asarray([3]), 0.9, 0, 7)
    batch = rng.randn(3, 64).astype(np.float32)
    batch[1] = row[0]
    batched = _both_samplers(batch, np.asarray([0, 5, 9]),
                             np.asarray([0, 3, 0]), 0.9, 0, 7)
    assert alone[0] == batched[1]
    _both_samplers(row, np.asarray([6]), np.asarray([3]), 0.9, 0, 7)


def test_sampler_top_k_restricts_support():
    """The reference's case, token for token: top-2 at temperature 5."""
    logits = np.random.RandomState(2).randn(8, 50).astype(np.float32)
    for idx in range(50):
        got = _both_samplers(logits, np.arange(8), np.full(8, idx), 5.0, 2, 0)
        for b in range(8):
            assert int(got[b]) in np.argsort(logits[b])[-2:].tolist()


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("temperature", [0.5, 0.8, 2.0])
@pytest.mark.parametrize("top_k", [0, 1, 8, 50])
def test_sampler_matches_reference_on_random_logits(seed, temperature,
                                                    top_k):
    rng = np.random.RandomState(seed * 100 + top_k)
    logits = (rng.randn(8, 1000) * 2).astype(np.float32)
    _both_samplers(logits, rng.randint(0, 1000, 8), rng.randint(0, 300, 8),
                   temperature, top_k, seed)


def test_sampler_keeps_ties_at_the_kth_logit():
    """``x < kth`` keeps every logit equal to the k-th largest, so more
    than k tokens may survive; the port draws what the reference draws."""
    x = np.zeros((4, 64), np.float32)
    x[:, :10], x[:, 10:20] = 1.0, 0.5
    for k in (3, 10, 15):
        for idx in range(8):
            got = _both_samplers(x, np.arange(4), np.full(4, idx), 1.0, k, 5)
            assert (got < (10 if k <= 10 else 20)).all()


def test_sampler_full_vocabulary_matches_reference():
    """[8, 128,256] logits, the serving shape of llama3.2: temperature 0.8,
    top-k 50, seed 11."""
    logits = np.random.RandomState(4).randn(8, 128_256).astype(np.float32)
    _both_samplers(logits, np.arange(8) + 40, np.arange(8) * 3, 0.8, 50, 11)


def test_sampler_rejects_negative_top_k():
    with pytest.raises(ValueError, match="top_k"):
        TokenSampler(0.8, -1)


# ---------------------------------------------------------------------------
# sampled engine streams against the reference engine's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [SAMPLED, dict(temperature=0.8, top_k=8,
                                              sample_seed=3)],
                         ids=["t0.8", "t0.8_top8"])
def test_sampled_streams_match_reference_under_swap(models, kw):
    st = _both(models, _workload(1, 10, shared_ratio=0.5), num_pages=12,
               **kw)
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0


def test_temperature_zero_top_k_equals_greedy(models):
    """The reference's case: ``temperature 0, top_k 4`` is the greedy
    engine, in the port and against the reference."""
    _, _, tapi, tparams = models
    wl = _workload(5, 6)
    greedy = _drive(_torch_engine(tapi, tparams), wl)
    assert _both(models, wl, temperature=0.0, top_k=4)["completed"] == 6
    assert _drive(_torch_engine(tapi, tparams, temperature=0.0, top_k=4),
                  wl) == greedy


def test_sampling_deterministic_and_isolated(models):
    """The reference's case: a rerun repeats the streams, and a request
    sampled alone equals the same request sampled in a shared batch."""
    _, _, tapi, tparams = models

    def run(n_extra):
        eng = _torch_engine(tapi, tparams, **SAMPLED)
        rng = np.random.RandomState(6)
        first = eng.submit(rng.randint(0, 512, size=6).tolist(), 8)
        for _ in range(n_extra):
            eng.submit(rng.randint(0, 512, size=4).tolist(), 5)
        eng.run(max_steps=80)
        return first.generated

    batched = run(3)
    assert batched == run(3) == run(0)


def test_chunked_sampled_streams_equal_one_shot_and_reference(models):
    """The reference's chunked x sampling case: keys thread (rid, index),
    so chunking cannot move a sampled stream."""
    japi, jparams, tapi, tparams = models
    kw = dict(temperature=0.8, top_k=8, sample_seed=3)
    wl = _workload(19, 8)
    want = _drive(_jax_engine(japi, jparams, **kw), wl)
    one_shot = _torch_engine(tapi, tparams, **kw)
    chunked = _torch_engine(tapi, tparams, prefill_chunk=5, prefill_pack=3,
                            **kw)
    assert _drive(one_shot, wl, audit=_audit) == want
    assert _drive(chunked, wl, audit=_audit) == want
    st = chunked.stats()
    assert st["chunked_admissions"] > 0 and st["packed_admissions"] > 0


# ---------------------------------------------------------------------------
# stream identities inside the port, under sampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup", [False, True], ids=["eager", "warmed"])
def test_disagg_sampled_equals_monolithic(models, warmup):
    """A handed-off request keeps its rid on the decode role, so its
    sampled stream is the monolithic engine's from the second token on."""
    _, _, tapi, tparams = models
    kw = dict(SAMPLED, top_k=8, num_pages=14)
    wl = _workload(2, 10, shared_ratio=0.5)
    mono = _drive(_torch_engine(tapi, tparams, **kw), wl)
    orch = build_disagg(tapi, tparams, config=EngineConfig(**{**BASE, **kw}),
                        backend="local", device="cpu", warmup=warmup)
    assert _drive_orch(orch, [(p, n, None, g) for p, n, g in wl]) == mono
    st = orch.stats()
    assert st["handoffs"] > 0
    if warmup:
        for eng in (orch.decode, orch.eng_prefill):
            assert eng.stats()["compile_stalls"] == []


def test_warmed_sampled_engine_equals_cold(models):
    """Warmup's traffic samples too; the reset restarts rids at 0, so the
    warmed engine's sampled streams are the cold engine's, with the
    sampler warmed at both batch shapes and no stall after warmup."""
    _, _, tapi, tparams = models
    kw = dict(SAMPLED, top_k=8, num_pages=12)
    wl = _workload(1, 10, shared_ratio=0.5)
    cold = _drive(_torch_engine(tapi, tparams, **kw), wl)
    eng = _torch_engine(tapi, tparams, warmup=True, **kw)
    assert _drive(eng, wl, audit=_audit) == cold
    st = eng.stats()
    assert st["swap_ins"] > 0 and st["compile_stalls"] == []
    assert len(eng.aot.fns["sample"].signatures) == 2       # [1, V], [4, V]


@pytest.mark.parametrize("seed,num_pages", [(3, 12), (9, 9)])
def test_sampled_swap_equals_recompute_equals_undisturbed(models, seed,
                                                          num_pages):
    """A resumed request continues its keystream at ``len(generated)``,
    whether its pages come back sealed or are recomputed."""
    _, _, tapi, tparams = models
    wl = _workload(seed, 10, shared_ratio=0.5)
    swap = _torch_engine(tapi, tparams, num_pages=num_pages, **SAMPLED)
    rec = _torch_engine(tapi, tparams, num_pages=num_pages,
                        preempt_policy="recompute", **SAMPLED)
    a = _drive(swap, wl, audit=_audit)
    b = _drive(rec, wl, audit=_audit)
    c = _drive(_torch_engine(tapi, tparams, **SAMPLED), wl)
    assert a == b == c
    assert swap.stats()["swap_ins"] > 0 and rec.stats()["preemptions"] > 0


@pytest.mark.parametrize("field,other", [("temperature", 0.7), ("top_k", 4),
                                         ("sample_seed", 12),
                                         ("page_size", 8)])
def test_pair_refuses_a_sampler_mismatch(models, field, other):
    _, _, tapi, tparams = models
    decode = ServingEngine(tapi, EngineConfig(**{
        **BASE, **SAMPLED, "disagg_role": "decode"}), tparams, device="cpu")
    pre = ServingEngine(tapi, EngineConfig(**{
        **BASE, **SAMPLED, "disagg_role": "prefill", field: other}),
        tparams, device="cpu")
    with pytest.raises(ValueError, match=field):
        DisaggOrchestrator(decode, PrefillEngine(pre))


SERVE = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
         "--backend", "local", "--slots", "3", "--microbatches", "1",
         "--requests", "6", "--max-new", "14", "--page-size", "4",
         "--no-seal", "--f32", "--warmup", "--assert-no-recompile",
         "--temperature", "0.8", "--top-k", "50"]


@pytest.mark.parametrize("extra", [
    ["--prompt-len", "6", "--num-pages", "8", "--no-prefix-sharing",
     "--preempt-policy", "swap", "--verify-preempt"],
    ["--prompt-len", "8", "--disagg", "--verify-disagg"],
    ["--prompt-len", "24", "--prefill-chunk", "5", "--prefill-pack", "3",
     "--verify-chunked"]], ids=["preempt", "disagg", "chunked"])
def test_serve_samples_through_every_verifier(extra):
    """serve's ``--temperature`` and ``--top-k`` on reduced llama3.2-3b,
    warmed, under the launcher's own stream checks: swap = recompute =
    roomy pool, disaggregated = monolithic = no-peer fallback, chunked =
    one-shot."""
    from repro_torch.launch import serve
    st = serve.main(SERVE + extra)
    assert st["completed"] + st.get("prefill_completed", 0) == 6


def test_serve_constructors_take_config_overrides(models):
    """serve's ``make_engine`` and ``make_disagg`` set config fields that
    have no flag (``sample_seed``, as the reference's serve has none) and
    replace flagged ones, on both roles of a pair; the other flags hold."""
    from repro_torch.launch import serve
    _, _, tapi, tparams = models
    args = serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--device", "cpu", "--backend", "local",
         "--slots", "3", "--microbatches", "1", "--temperature", "0.8",
         "--top-k", "50"])
    eng = serve.make_engine(tapi, tparams, args, sample_seed=5, top_k=7)
    assert (eng.config.sample_seed, eng.config.top_k,
            eng.config.temperature, eng.config.num_slots) == (5, 7, 0.8, 3)
    assert (eng.sampler.seed, eng.sampler.top_k) == (5, 7)
    orch = serve.make_disagg(tapi, tparams, args, sample_seed=5)
    for role in (orch.decode, orch.eng_prefill):
        assert (role.config.sample_seed, role.config.top_k) == (5, 50)
    with pytest.raises(TypeError):
        serve.make_config(args, no_such_field=1)
