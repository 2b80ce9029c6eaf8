"""The port's checkpoint manager (``repro_torch.checkpoint``): the
reference's tests (tests/test_checkpoint.py) on the port, and checkpoints
crossing between the two packages in both directions.

A train state saved by either package has the same ``arrays.npz`` keys
(JAX's key-path names: ``opt/.master/embed``, ``params/blocks/ln1``) and
the same manifest ``leaves`` (shapes, and dtypes after bf16 is widened to
f32); every leaf restores bit for bit in the other package; and a run
restored from the other package's save continues to that package's own
next losses (f32, rtol 1e-5: the ``loss_fn`` tolerance of
tests/test_torch_train.py).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.checkpoint import CheckpointManager, TensorSpec
from repro_torch.configs import ShapeConfig
from repro_torch.data import SyntheticTokenStream
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.tree import leaves
from repro_torch.weights import tensor_from_numpy
from test_torch_train import (B, OPT, S, jax_train_step, jbatch, models)


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


def tree(key=0):
    g = torch.Generator().manual_seed(key)
    return {"w": torch.randn(8, 16, generator=g),
            "b": (torch.arange(4, dtype=torch.int32),
                  torch.ones(3, dtype=torch.bfloat16))}


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    t = tree()
    m.save(5, t)
    out = m.restore(5, t)
    for a, b in zip(leaves(out), leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.save(s, tree(s))
    assert m.latest_step() == 4
    assert m.all_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)
    t = tree(7)
    m.save(1, t)
    t["w"].add_(1.0)          # the save copied the leaves when called
    m.wait()
    out = m.restore(1, t)
    assert torch.equal(out["w"], tree(7)["w"])


def test_corruption_detected(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    t = tree()
    m.save(2, t)
    p = os.path.join(str(tmp_path), "step_2", "manifest.json")
    with open(p, "a") as f:
        f.write(" ")
    with pytest.raises(AssertionError):
        m.restore(2, t)


def test_shape_mismatch_detected(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(3, tree())
    bad = {"w": torch.zeros(4, 4), "b": (torch.zeros(4, dtype=torch.int32),
                                         torch.zeros(3, dtype=torch.bfloat16))}
    with pytest.raises(ValueError):
        m.restore(3, bad)


def test_extra_metadata(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(9, tree(), extra={"data": {"step": 9}})
    assert m.manifest(9)["extra"]["data"]["step"] == 9


def test_restore_onto_specs_and_dtypes(tmp_path):
    """``TensorSpec`` leaves (the reference's ``ShapeDtypeStruct``) give
    shape, dtype and device; an f32 save restores into bf16 by rounding,
    as the reference's ``astype`` does."""
    m = CheckpointManager(str(tmp_path), async_save=False)
    t = tree(3)
    m.save(1, t)
    like = {"w": TensorSpec((8, 16), torch.bfloat16, "cpu"),
            "b": (TensorSpec((4,), torch.int32, "cpu"),
                  TensorSpec((3,), torch.float32, "cpu"))}
    out = m.restore(1, like)
    assert torch.equal(out["w"], t["w"].to(torch.bfloat16))
    assert out["b"][1].dtype == torch.float32
    assert torch.equal(out["b"][0], t["b"][0])


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
def _jax_state(jp):
    from repro.optim import adamw as jax_adamw
    return {"params": jp, "opt": jax_adamw.init(jp)}


def _port_state(tp):
    return {"params": tp, "opt": adamw.init(tp)}


def _files(d, step):
    with np.load(os.path.join(d, f"step_{step}", "arrays.npz")) as z:
        keys = list(z.keys())
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        man = json.load(f)
    return keys, man


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_layouts_are_the_same(f32, tmp_path, variant):
    """Both packages write the same npz keys, in the same order, and the
    same manifest leaves for one train state; bf16 is widened to f32 in
    both."""
    _, jp, _, tp = models(variant)
    JaxManager(str(tmp_path / "jax"), async_save=False).save(
        2, _jax_state(jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)),
        extra={"step": 2})
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        2, _port_state(jax.tree.map(lambda t: t.to(torch.bfloat16), tp)),
        extra={"step": 2})
    jk, jm = _files(str(tmp_path / "jax"), 2)
    tk, tm = _files(str(tmp_path / "port"), 2)
    assert jk == tk and "opt/.master/embed" in jk \
        and "params/blocks/ln1" in jk
    assert jm["leaves"] == tm["leaves"]
    assert list(jm["leaves"]) == list(tm["leaves"])
    assert {v["dtype"] for v in tm["leaves"].values()} == {"float32"}
    assert jm["extra"] == tm["extra"] and sorted(jm) == sorted(tm)
    assert (tmp_path / "jax" / "LATEST").read_text() == \
        (tmp_path / "port" / "LATEST").read_text()


def test_bf16_leaves_cross_bit_for_bit(tmp_path):
    """A bf16 tree saved by one package restores bit-equal in the other,
    int32 and f32 leaves too."""
    rng = np.random.RandomState(0)
    w = rng.randn(8, 16).astype(np.float32)
    jt = {"w": jnp.asarray(w).astype(jnp.bfloat16),
          "b": (jnp.arange(4, dtype=jnp.int32), jnp.asarray(w[0]))}
    tt = {"w": tensor_from_numpy(np.asarray(jt["w"])),
          "b": (torch.arange(4, dtype=torch.int32), torch.from_numpy(w[0]))}
    JaxManager(str(tmp_path / "j"), async_save=False).save(1, jt)
    got = CheckpointManager(str(tmp_path / "j")).restore(1, tt)
    for a, b in zip(leaves(got), leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(1, tt)
    back = JaxManager(str(tmp_path / "t")).restore(1, jt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def _port_loop(tapi, tp, ckpt, steps, ckpt_every=50):
    step = make_train_step(tapi, AdamWConfig(**OPT),
                           ShapeConfig("t", S, B, "train"), device="cpu")
    return TrainLoop(train_step=step, params=tp, opt_state=adamw.init(tp),
                     data=SyntheticTokenStream(tapi.cfg.vocab_size, B, S,
                                               seed=1),
                     ckpt=ckpt, cfg=TrainLoopConfig(total_steps=steps,
                                                    ckpt_every=ckpt_every))


def test_reference_save_continues_in_the_port_and_back(f32, tmp_path):
    """The reference trains 2 steps and saves (its layout, with the data
    cursor); the port restores onto junk state and takes 2 more steps,
    whose losses equal the reference's own steps 3 and 4 (rtol 1e-5). The
    reverse: the port trains 2 steps and saves through its loop, the
    reference restores and continues to the port's steps 3 and 4."""
    japi, jp, tapi, tp = models("dense")
    jstep = jax_train_step(japi, **OPT)
    state = _jax_state(jp)
    data = SyntheticTokenStream(tapi.cfg.vocab_size, B, S, seed=1)
    jl = []
    for i in range(4):
        loss, state["params"], state["opt"], _ = jstep(
            state["params"], state["opt"], jbatch(next(data)), i)
        jl.append(float(loss))
        if i == 1:
            JaxManager(str(tmp_path / "j"), async_save=False).save(
                2, state, extra={"data": data.state_dict(), "step": 2})

    _, _, _, junk = models("dense", seed=5)
    loop = _port_loop(tapi, junk, CheckpointManager(str(tmp_path / "j")), 2)
    assert loop.try_restore() and loop.step == 2 and loop.data.step == 2
    assert isinstance(loop.opt_state, AdamWState)
    out = loop.run(2)
    np.testing.assert_allclose(out["losses"], jl[2:], rtol=1e-5)

    port = _port_loop(tapi, models("dense")[3],
                      CheckpointManager(str(tmp_path / "t"),
                                        async_save=False), 4, ckpt_every=2)
    tl = port.run(4)["losses"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    mgr = JaxManager(str(tmp_path / "t"))
    assert mgr.all_steps() == [2, 4] and mgr.latest_step() == 4
    like = _jax_state(jax.tree.map(jnp.zeros_like, jp))
    restored = mgr.restore(2, like)
    extra = mgr.manifest(2)["extra"]
    assert extra == {"data": {"step": 2, "seed": 1}, "step": 2}
    data = SyntheticTokenStream(tapi.cfg.vocab_size, B, S)
    data.load_state_dict(extra["data"])
    st = restored
    cont = []
    for i in (2, 3):
        loss, st["params"], st["opt"], _ = jstep(
            st["params"], st["opt"], jbatch(next(data)), i)
        cont.append(float(loss))
    np.testing.assert_allclose(cont, tl[2:], rtol=1e-5)
