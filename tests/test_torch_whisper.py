"""Whisper on the port (``models/whisper.py``) against the JAX package
(CPU, f32, reduced whisper-small: 4 decoder and 2 encoder blocks, 4 heads
x 16, d 64, 24 frames, ``max_seq`` 64).

The same parameters (drawn by the JAX package, the zero-initialized
attention and MLP biases drawn nonzero there, carried across with
``params_from_jax``) and the same numpy inputs go through both packages.
Tolerances, each of the largest |value| of the output or leaf compared
(f32 sums in another order). The random init's attention scores reach
150 (its projections draw with the layer count as fan-in), so an ulp of a
score moves its softmax weight by about 1e-5 and the packages drift
apart by that much a layer:

* non-causal ``chunked_attention`` at Sq != Sk, ``gelu_mlp`` and
  ``layernorm``: atol = rtol = 1e-5 (measured 1e-7 on the attention);
* ``encode`` (2 blocks) and decode logits from one carried-across cache:
  2e-5 (measured 1.01e-5 and below 1e-5);
* the prefill's logits and caches (2 encoder and 4 decoder blocks): 2e-4
  (measured 1.1e-4 on the logits);
* the loss within rtol 1e-5; every gradient within 5e-4 of its leaf's
  largest (``test_torch_train.GRAD_REL``), but the key biases, whose
  gradient is zero (softmax ignores a shift shared by every key) and in
  both packages rounding noise: below 1e-6 of the largest gradient;
* within the port, decode after prefill S on its cache grown by 8 zero
  positions against the prefill of S + 1: 1e-4 (the reference's own
  measures 1.05e-5). On the prefill's own cache, exactly S long, decode
  writes at ``min(len, S - 1)`` and so overwrites the prompt's last
  position, as the reference's does: that decode equals the
  reference's, not prefill S + 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.models import layers as L
from repro_torch.weights import cache_from_jax, params_from_jax
from test_torch_train import assert_grads_close
from test_torch_vlm import _j, _t, f32, pair  # noqa: F401 (fixture)

ARCH = "whisper-small"
REL = 2e-5
PREFILL_REL = 2e-4
SELF_REL = 1e-4
TOL = dict(atol=1e-5, rtol=1e-5)
GROW = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wh(f32):
    japi, jparams, tapi, _ = pair(ARCH, max_seq=64, jit_init=True)
    rng = np.random.RandomState(9)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bi']") or name.endswith("['bo']"):
            return jnp.asarray(0.1 * rng.randn(*x.shape), jnp.float32)
        return x
    jparams = jax.tree_util.tree_map_with_path(draw, jparams)
    return japi, jparams, tapi, params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "frames": rng.randn(B, cfg.encoder_seq,
                                cfg.d_model).astype(np.float32)}


def _prefill_batch(b):
    return {k: v for k, v in b.items() if k != "labels"}


def _grow(cache, n):
    """The self-attention cache padded by ``n`` zero positions (axis 3 of
    [L, B, KVH, S, D]), so a decode step at ``len`` = S writes a fresh
    slot."""
    out = dict(cache)
    out["kv"] = tuple(torch.nn.functional.pad(t, (0, 0, 0, n))
                      for t in cache["kv"])
    return out


def test_layers_equal_reference():
    """``gelu_mlp`` (JAX's default tanh GELU), ``linear`` and ``layernorm``
    against the reference's."""
    import repro.models.layers as JL
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32) * 3
    wi, wo = rng.randn(16, 32).astype(np.float32), \
        rng.randn(32, 16).astype(np.float32)
    bi, bo = rng.randn(32).astype(np.float32), rng.randn(16).astype(np.float32)
    want = JL.gelu_mlp(*map(jnp.asarray, (x, wi, wo, bi, bo)))
    got = L.gelu_mlp(*map(torch.from_numpy, (x, wi, wo, bi, bo)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        L.linear(torch.from_numpy(x), torch.from_numpy(wi)).numpy(),
        np.asarray(JL.linear(jnp.asarray(x), jnp.asarray(wi))), **TOL)
    scale, bias = rng.randn(16).astype(np.float32), \
        rng.randn(16).astype(np.float32)
    np.testing.assert_allclose(
        L.layernorm(*map(torch.from_numpy, (x, scale, bias))).numpy(),
        np.asarray(JL.layernorm(*map(jnp.asarray, (x, scale, bias)))),
        **TOL)


@pytest.mark.parametrize("Sq,Sk", [(5, 24), (37, 150)])
def test_noncausal_chunked_attention_equals_reference(Sq, Sk):
    """Cross-attention's shape: Sq queries against Sk != Sq keys, no mask,
    through the flash wrapper's plain version."""
    import repro.models.layers as JL
    rng = np.random.RandomState(Sq)
    q = rng.randn(2, Sq, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, Sk, 4, 16).astype(np.float32) for _ in range(2))
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=False)
    got = L.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_and_prefill_equal_reference(wh):
    """``encode`` [B, S_enc, d], then ``prefill_fn``'s logits, self- and
    cross-attention caches ([L, B, KVH, S, D] and [L, B, KVH, S_enc, D])
    and ``len``."""
    japi, jparams, tapi, tparams = wh
    cfg = tapi.cfg
    b = _batch(cfg, 2, 12, 1)
    jm = jax.jit(japi.model.encode)(jparams, jnp.asarray(b["frames"]))
    tm = tapi.model.encode(tparams, torch.from_numpy(b["frames"]))
    assert tuple(tm.shape) == (2, cfg.encoder_seq, cfg.d_model)
    _close(tm, jm)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, _j(_prefill_batch(b)))
    tl, tc = tapi.prefill_fn(tparams, _t(_prefill_batch(b)))
    _close(tl, jl, PREFILL_REL)
    assert sorted(tc) == sorted(jc) == ["kv", "len", "xkv"]
    assert int(tc["len"]) == int(jc["len"]) == 12
    L_, KVH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    for part, S in (("kv", 12), ("xkv", cfg.encoder_seq)):
        for got, want in zip(tc[part], jc[part]):
            assert tuple(got.shape) == want.shape == (L_, 2, KVH, S, D)
            _close(got, want, PREFILL_REL)


def test_decode_equals_reference_and_prefill_plus_one(wh):
    """Decode from the reference's prefill cache carried across: on the
    cache as it is (S long: the step overwrites position S - 1, as the
    reference's does) the logits equal the reference's and differ from
    prefill S + 1; on a grown cache four steps equal the reference's.
    Within the port, prefill S then decode one on the grown cache equals
    prefill S + 1."""
    japi, jparams, tapi, tparams = wh
    cfg = tapi.cfg
    b = _batch(cfg, 2, 13, 2)
    S = 12
    pb = {"tokens": b["tokens"][:, :S], "frames": b["frames"]}
    _, jc = jax.jit(japi.prefill_fn)(jparams, _j(pb))
    jdecode = jax.jit(japi.decode_fn)
    nxt = b["tokens"][:, S:]
    jl, _ = jdecode(jparams, jc, {"tokens": jnp.asarray(nxt)})
    tl, tc = tapi.decode_fn(tparams,
                            cache_from_jax(jax.tree.map(np.asarray, jc),
                                           "cpu"),
                            {"tokens": torch.from_numpy(nxt)})
    _close(tl, jl)
    assert int(tc["len"]) == S + 1
    full, _ = tapi.prefill_fn(tparams, _t(_prefill_batch(b)))
    scale = float(full.abs().max())
    assert float((tl - full).abs().max()) > 1e-3 * scale   # the clamp bit
    jg = dict(jc)
    jg["kv"] = tuple(jnp.pad(t, ((0, 0),) * 3 + ((0, GROW), (0, 0)))
                     for t in jc["kv"])
    tg = _grow(cache_from_jax(jax.tree.map(np.asarray, jc), "cpu"), GROW)
    rng = np.random.RandomState(3)
    for i in range(4):
        tok = nxt if i == 0 else rng.randint(
            0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jg = jdecode(jparams, jg, {"tokens": jnp.asarray(tok)})
        tl, tg = tapi.decode_fn(tparams, tg, {"tokens": torch.from_numpy(tok)})
        _close(tl, jl)
    for got, want in zip(tg["kv"], jg["kv"]):
        _close(got, want)
    assert int(tg["len"]) == int(jg["len"]) == S + 4
    _, own = tapi.prefill_fn(tparams, _t(pb))
    tl, _ = tapi.decode_fn(tparams, _grow(own, GROW),
                           {"tokens": torch.from_numpy(nxt)})
    _close(tl, full.numpy(), SELF_REL)


def test_loss_and_grads_equal_reference(wh):
    """``loss_fn`` (encoder always rematerialized, decoder in training)
    and every gradient against ``jax.value_and_grad``."""
    japi, jparams, tapi, tparams = wh
    b = _batch(tapi.cfg, 2, 10, 5)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss_fn))(jparams, _j(b))
    tracked = jax.tree.map(lambda t: t.detach().clone().requires_grad_(),
                           tparams)
    tl = tapi.loss_fn(tracked, _t(b))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree.leaves(jg))
    zero = {k: jg[k]["attn"].pop("bk") for k in ("enc", "dec")}
    zero["x"] = jg["dec"]["xattn"].pop("bk")
    got = jax.tree.map(lambda t: t.grad, tracked)
    for k, g in zero.items():
        t = (got["dec"]["xattn"] if k == "x" else got[k]["attn"]).pop("bk")
        assert float(np.abs(np.asarray(g)).max()) < floor
        assert float(t.abs().max()) < floor
    assert_grads_close(got, jg)


def test_input_specs_and_cache_specs_equal_reference(wh):
    """``input_specs`` with ``frames`` [B, encoder_seq, d] outside decode,
    ``make_inputs`` drawing them, and ``init_cache`` shaped as the
    reference's."""
    from repro.configs import ShapeConfig as JShape
    japi, _, tapi, tparams = wh
    for kind in ("train", "prefill", "decode"):
        got = tapi.input_specs(ShapeConfig("s", 16, 2, kind))
        want = japi.input_specs(JShape("s", 16, 2, kind))
        assert sorted(got) == sorted(want)
        for name, (shape, _) in got.items():
            assert shape == want[name].shape, (kind, name)
        assert ("frames" in got) == (kind != "decode")
    batch = tapi.make_inputs(ShapeConfig("p", 16, 2, "prefill"),
                             torch.Generator().manual_seed(0))
    assert tuple(batch["frames"].shape) == (2, tapi.cfg.encoder_seq,
                                            tapi.cfg.d_model)
    cache = tapi.init_cache(2, 16)
    jcache = japi.init_cache(2, 16)
    for part in ("kv", "xkv"):
        assert [tuple(t.shape) for t in cache[part]] == \
            [t.shape for t in jcache[part]]
    assert int(cache["len"]) == 0
    assert not tapi.paged_ok and not japi.paged_ok


def test_engine_refuses_whisper_as_the_reference(wh):
    """No single homogeneous segment: both engines refuse Whisper at
    construction, in the reference's words (its ``assert``, the port's
    ``ValueError``)."""
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    from repro_torch.serving import EngineConfig, ServingEngine
    japi, jparams, tapi, tparams = wh
    msg = "serving needs a single homogeneous segment"
    with pytest.raises(AssertionError, match=msg):
        JEngine(japi, config=JCfg(), params=jparams, backend="local")
    with pytest.raises(ValueError, match=msg):
        ServingEngine(tapi, EngineConfig(), tparams, device="cpu",
                      backend="local")
