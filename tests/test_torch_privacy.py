"""The port's privacy metrics and per-block hidden states against the JAX
package (CPU).

``pearson``, ``ssim``, ``downsample_similarity`` and
``lm_similarity_profile`` must give the reference's values within 1e-5 on
the same numpy inputs (f32 sums in another order); the resize under the
image metric (``privacy.resize_linear``, torch's antialiased bilinear)
must give ``jax.image.resize(..., "linear")``'s pixels within 1e-5 when it
downsamples and when it upsamples. The reference's privacy tests run on
the port. ``StackedLM.hidden_states_fn`` at reduced llama3.2-1b in f32,
and a GQA variant, gives the reference's ``[L+1, B, S, D]`` within atol
= rtol = 1e-4, the port's model tolerance, with each layer's atol taken
relative to its largest |value|: these are raw residual streams (no final
norm), which grow to several hundred after one block of the reference's
random init, and f32 sums in another order move them by up to ~1e-5 of
that. The similarity profile and private depth must be the reference's
too. Reduced qwen2-moe-a2.7b drops at capacity in
train mode, where f32 noise can flip a dropping decision between the
packages; its blocks are held one by one, each from the reference's own
input to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as JP
from repro.data.stream import VideoChunkStream as JStream
from repro_torch.core import privacy as P
from repro_torch.data.stream import VideoChunkStream
from test_torch_configs import _models, _pair

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32():
    import repro.models.layers as JL
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    yield
    JL.DEFAULT_DTYPE = old


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(64, 64), (30, 45), (7, 9), (3, 5, 8)])
def test_pearson_equals_reference(shape):
    a, noise = _img(shape, 0), _img(shape, 1)
    for b in (a, 0.7 * a + 0.3 * noise, noise, 1.0 - a):
        got = P.pearson(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(float(got), float(JP.pearson(
            jnp.asarray(a), jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("shape,win", [((64, 64), 8), ((30, 45), 8),
                                       ((112, 112), 8), ((40, 24), 5)])
def test_ssim_equals_reference(shape, win):
    a, noise = _img(shape, 2), _img(shape, 3)
    for b in (a, 0.8 * a + 0.2 * noise, noise):
        got = P.ssim(torch.from_numpy(a), torch.from_numpy(b), win=win)
        want = JP.ssim(jnp.asarray(a), jnp.asarray(b), win=win)
        np.testing.assert_allclose(float(got), float(want), **TOL)
    # the population variance, as jnp.var's: a constant window's ssim is 1
    c = torch.full(shape, 0.5)
    assert abs(float(P.ssim(c, c, win=win)) - 1.0) < 1e-6


@pytest.mark.parametrize("src,dst", [((224, 224), (55, 55)),
                                     ((224, 224), (112, 112)),
                                     ((224, 224), (111, 111)),
                                     ((224, 224), (7, 7)),
                                     ((55, 55), (27, 27)),
                                     ((13, 13), (6, 6)),
                                     ((6, 6), (2, 2)),
                                     ((7, 7), (224, 224)),
                                     ((12, 12), (112, 112)),
                                     ((27, 27), (27, 27))])
def test_resize_linear_equals_jax_image_resize(src, dst):
    x = _img((3,) + src, 4)
    got = P.resize_linear(torch.from_numpy(x), dst)
    want = jax.image.resize(jnp.asarray(x), (3,) + dst, "linear")
    assert tuple(got.shape) == (3,) + dst
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("res", [224, 112])
@pytest.mark.parametrize("metric", ["ssim", "pearson"])
def test_downsample_similarity_equals_reference(res, metric):
    for chunk in (0, 1):
        img = VideoChunkStream(resolution=res).frame(chunk, 0)[:, :, 0]
        jimg = JStream(resolution=res).frame(chunk, 0)[:, :, 0]
        assert np.array_equal(img, jimg)
        for r in (112, 56, 28, 20, 14, 12, 7):
            got = P.downsample_similarity(torch.from_numpy(img), r, metric)
            assert isinstance(got, float)
            want = JP.downsample_similarity(jnp.asarray(jimg), r, metric)
            np.testing.assert_allclose(got, want, **TOL)


def test_downsample_similarity_monotone():
    """The reference's test, on the port."""
    img = torch.from_numpy(VideoChunkStream(resolution=112).frame(0, 0)
                           [:, :, 0])
    sims = [P.downsample_similarity(img, r) for r in (112, 56, 28, 14, 7)]
    assert all(a >= b - 0.02 for a, b in zip(sims, sims[1:])), sims
    assert sims[0] > 0.95
    assert sims[-1] < sims[0] - 0.2


def test_threshold_20px_separates():
    img = torch.from_numpy(VideoChunkStream(resolution=112).frame(1, 0)
                           [:, :, 0])
    assert P.downsample_similarity(img, 28) > \
        P.downsample_similarity(img, 12)


@pytest.mark.parametrize("shape", [(5, 2, 8, 16), (3, 1, 4, 64),
                                   (17, 2, 3, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_similarity_profile_equals_reference(shape, dtype):
    h = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    h[1] = h[0] * 2.0 + 0.1 * h[1]          # one block close to the input
    jh = jnp.asarray(h).astype(dtype)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    got = P.lm_similarity_profile(th)
    want = JP.lm_similarity_profile(jh)
    assert isinstance(got, np.ndarray) and got.shape == (shape[0] - 1,)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got >= 0).all() and (got <= 1.0 + 1e-6).all()
    assert P.private_depth(got, 0.5) == JP.private_depth(want, 0.5)


def test_lm_similarity_profile_of_the_input_is_one():
    x = torch.randn(2, 4, 16, generator=torch.Generator().manual_seed(0))
    sims = P.lm_similarity_profile(torch.stack([x, x, -3 * x, x.flip(-1)]))
    np.testing.assert_allclose(sims[:2], 1.0, atol=1e-6)
    assert sims[2] < 1.0


def _close_to_layer(got, want):
    """atol = rtol = 1e-4, atol in units of the layer's largest |value|."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _tokens(vocab, B=2, S=24, seed=6):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("kw", [{}, dict(num_kv_heads=2)],
                         ids=["llama3.2-1b", "gqa"])
def test_hidden_states_equal_reference(f32, kw):
    japi, jparams, tapi, tparams = _pair("llama3.2-1b", kw)
    cfg = tapi.cfg
    toks = _tokens(cfg.vocab_size)
    want = np.asarray(japi.model.hidden_states_fn(
        jparams, {"tokens": jnp.asarray(toks)}))
    got = tapi.model.hidden_states_fn(tparams,
                                      {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == \
        (cfg.num_layers + 1,) + toks.shape + (cfg.d_model,)
    assert got.dtype == torch.float32 and not got.requires_grad
    for g, w in zip(got.numpy(), want):
        _close_to_layer(g, w)
    assert torch.equal(got[0], tparams["embed"][torch.from_numpy(toks)
                                                .long()])
    sims = P.lm_similarity_profile(got)
    np.testing.assert_allclose(sims, JP.lm_similarity_profile(want),
                               **MODEL_TOL)
    assert P.private_depth(sims, P.LM_SIM_DELTA) == \
        JP.private_depth(JP.lm_similarity_profile(want), JP.LM_SIM_DELTA)


def test_hidden_states_run_every_block_without_autograd(f32):
    """Under autograd the port's blocks would take the flash kernel's
    training Function; the profile pass records nothing."""
    _, _, tapi, tparams = _models("llama3.2-3b")
    params = {k: v for k, v in tparams.items()}
    params["embed"] = tparams["embed"].clone().requires_grad_(True)
    toks = torch.from_numpy(_tokens(tapi.cfg.vocab_size, B=1, S=8))
    h = tapi.model.hidden_states_fn(params, {"tokens": toks})
    assert not h.requires_grad and h.grad_fn is None
    assert h.shape[0] == tapi.cfg.num_layers + 1


def test_moe_hidden_states_equal_reference_block_by_block(f32):
    from repro_torch.models.transformer import SEGMENT, _unbind
    japi, jparams, tapi, tparams = _models("qwen2-moe-a2.7b")
    cfg = tapi.cfg
    toks = _tokens(cfg.vocab_size, B=2, S=32)
    want = np.asarray(japi.model.hidden_states_fn(
        jparams, {"tokens": jnp.asarray(toks)}))
    got = tapi.model.hidden_states_fn(tparams,
                                      {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=0)
    positions = torch.arange(toks.shape[1])[None, :]
    blocks = _unbind(tparams[SEGMENT], cfg.num_layers)
    with torch.no_grad():
        for l, p in enumerate(blocks):
            x = torch.from_numpy(want[l].copy())
            out = tapi.model._block(p, x, positions, train=True)[0]
            _close_to_layer(out.numpy(), want[l + 1])
            # train mode drops at capacity: inference dispatch differs
            no_drop = tapi.model._block(p, x, positions)[0]
            if l == 0:
                assert not torch.allclose(no_drop, out, **MODEL_TOL)
