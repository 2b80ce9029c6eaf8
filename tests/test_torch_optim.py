"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's: the reference's optimizer tests (tests/test_optim.py, less the
compression case, which comes with multi-card placement) on the port, and
the same arithmetic on the same inputs. ``schedule`` and ``global_norm``
agree within 2 f32 ulps (rtol 2.4e-7); three ``update``s from the same
grads and state give master, moments and parameters within rtol 1e-6 plus
4 f32 ulps of the leaf's largest value (f32 operations in the reference's
order, but XLA may contract a multiply and an add into one rounding, and
``b1 * m + (1 - b1) * g`` cancels when the grads change sign)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.weights import opt_state_from_jax, params_from_jax

ULPS2 = dict(rtol=2.4e-7, atol=0)
UPDATE_RTOL = 1e-6
F32_EPS = float(np.finfo(np.float32).eps)


def _close_update(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=UPDATE_RTOL,
        atol=4 * F32_EPS * float(np.abs(want).max()))


def test_adamw_optimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3, dtype=torch.bfloat16)}
    state = adamw.init(params)
    for step in range(150):
        g = {"x": (state.master["x"] - target).to(torch.bfloat16)}
        params, state, _ = adamw.update(cfg, g, state, step)
    np.testing.assert_allclose(state.master["x"].numpy(), target.numpy(),
                               atol=0.1)
    assert params["x"].dtype == torch.bfloat16


def test_schedule_warmup_and_cosine():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, 0)) == 0.0
    assert abs(float(adamw.schedule(cfg, 10)) - 1.0) < 1e-6
    assert float(adamw.schedule(cfg, 100)) <= 0.1 + 1e-6
    assert float(adamw.schedule(cfg, 55)) < 1.0


def test_grad_clipping():
    cfg = AdamWConfig(clip_norm=1.0, lr=1.0, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    params = {"x": torch.zeros(4, dtype=torch.bfloat16)}
    state = adamw.init(params)
    huge = {"x": torch.full((4,), 1e6, dtype=torch.float32)}
    _, _, gnorm = adamw.update(cfg, huge, state, 0)
    assert float(gnorm) > 1e5   # reported norm is pre-clip


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_steps=3, total_steps=30),
    dict(lr=3e-3, warmup_steps=2, total_steps=60, min_lr_ratio=0.1),
    dict(lr=0.7, warmup_steps=0, total_steps=7, min_lr_ratio=0.0),
    dict(lr=2.5e-4, warmup_steps=100, total_steps=10_000)])
def test_schedule_equals_the_reference(cfg):
    tc, jc = AdamWConfig(**cfg), jax_adamw.AdamWConfig(**cfg)
    steps = sorted({0, 1, 2, 3, cfg["warmup_steps"], cfg["total_steps"] // 2,
                    cfg["total_steps"] - 1, cfg["total_steps"],
                    cfg["total_steps"] + 5})
    got = np.array([float(adamw.schedule(tc, s)) for s in steps], np.float32)
    want = np.array([float(jax_adamw.schedule(jc, s)) for s in steps],
                    np.float32)
    np.testing.assert_allclose(got, want, **ULPS2)
    # a step already on the device gives the same value
    dev = adamw.schedule(tc, torch.tensor(float(steps[-2])))
    assert float(dev) == got[-2]


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"embed": (rng.randn(33, 8) * 0.3).astype(dtype),
            "blocks": {"w": rng.randn(2, 8, 5).astype(dtype),
                       "ln": (1 + 0.1 * rng.randn(2, 8)).astype(dtype)},
            "ln_f": np.ones(8, dtype)}


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_global_norm_equals_the_reference(scale):
    g = jax.tree.map(lambda x: x * np.float32(scale), _tree(1))
    got = float(adamw.global_norm(params_from_jax(g, "cpu")))
    want = float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, g)))
    np.testing.assert_allclose(got, want, **ULPS2)


@pytest.mark.parametrize("grad_scale,step,wd", [
    (0.01, 0, 0.1), (1.0, 4, 0.1), (40.0, 17, 0.01)])
def test_update_equals_the_reference(grad_scale, step, wd):
    """Three updates from one start (state after the first reused), same
    grads in both packages; clipping engages at the larger grad scales."""
    jc = jax_adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                               weight_decay=wd)
    tc = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                     weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, _tree(2))
    js = jax_adamw.init(jp)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    tp = params_from_jax(_tree(2), "cpu")
    for i in range(3):
        g = jax.tree.map(lambda x: x * np.float32(grad_scale), _tree(10 + i))
        jp, js, jn = jax_adamw.update(jc, jax.tree.map(jnp.asarray, g), js,
                                      step + i)
        tp, ts, tn = adamw.update(tc, params_from_jax(g, "cpu"), ts,
                                  step + i, params=tp)
        np.testing.assert_allclose(float(tn), float(jn), **ULPS2)
    assert isinstance(ts, AdamWState)
    for field in AdamWState._fields:
        for a, b in zip(jax.tree.leaves(getattr(js, field)),
                        jax.tree.leaves(
                            jax.tree.map(lambda t: t.numpy(),
                                         getattr(ts, field)))):
            _close_update(b, a)
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp))):
        _close_update(b, a)


def test_update_in_place_and_into_params():
    """The state's tensors are updated in place; ``params=`` receives the
    new values (cast to the grads' dtype) in its own buffers, and without
    it the new parameters are fresh tensors, not the master copy."""
    params = {"a": torch.ones(4, dtype=torch.bfloat16),
              "b": torch.zeros(2, 3)}
    state = adamw.init(params)
    ids = [id(t) for f in state for t in f.values()]
    grads = {"a": torch.full((4,), 0.5, dtype=torch.bfloat16),
             "b": torch.ones(2, 3)}
    new, st, _ = adamw.update(AdamWConfig(warmup_steps=0), grads, state, 3,
                              params=params)
    assert [id(t) for f in st for t in f.values()] == ids
    assert new["a"] is params["a"] and new["a"].dtype == torch.bfloat16
    assert torch.equal(new["b"], st.master["b"])
    fresh, _, _ = adamw.update(AdamWConfig(warmup_steps=0), grads, st, 4)
    assert fresh["b"] is not st.master["b"]
    assert torch.equal(fresh["b"], st.master["b"])
