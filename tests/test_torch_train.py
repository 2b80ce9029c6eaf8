"""The port's training path against the JAX package's (CPU, f32 unless a
test says otherwise), and the reference's training tests
(tests/test_train_loop.py) on the port.

Tolerances, each stated where it is used:
- prefill attention's gradient (``ops.FlashAttentionFn``, the route the
  card takes) against ``jax.grad`` of the reference's
  ``chunked_attention``: atol = rtol = 1e-5; its plain backward against
  autograd of the plain forward: atol 2e-6 + rtol 1e-5;
- ``chunked_softmax_xent``: value rtol 1e-6, gradients atol 1e-6 +
  rtol 1e-5;
- ``loss_fn``: rtol 1e-5; every parameter gradient within 5e-4 of that
  leaf's largest reference gradient (f32 sums in other orders through
  every layer of both packages, observed up to 2e-4 on reduced
  qwen2-moe);
- three AdamW steps (dense): losses rtol 1e-5, grad norms rtol 1e-3 (the
  norm of step 2 sums grads of parameters that already differ), every
  parameter within twice the summed learning rates of the steps taken
  (what two Adam runs can differ by at most) and 95% of each leaf's
  elements within 1e-5 (lr / 300; a wrong update rule moves most elements
  by more): Adam divides a moment by its square root, so a gradient
  element near zero, whose f32 noise is large against its size, moves by
  up to lr in either package (observed: 1 element of 32,768 past 1e-4 in
  the embedding, 5 of 192 past 1e-5 in qwen2-moe's ``bk``);
- MoE steps are compared from the reference's state each step (same
  tolerances): capacity dropping is a discrete decision, so free-running
  copies part once a routing margin flips (from step 2 here), though
  each step agrees.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data import SyntheticTokenStream
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train
from repro_torch.weights import opt_state_from_jax, params_from_jax

VARIANTS = {"dense": ("llama3.2-1b", {}),
            "gqa": ("llama3.2-1b", {"num_kv_heads": 1}),
            "moe": ("qwen2-moe-a2.7b", {})}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=60, weight_decay=0.01)
B, S = 4, 32
GRAD_REL = 5e-4


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


def models(variant, seed=0):
    """(reference api, its f32 params, port api, the port's copy)."""
    from repro.models.api import build_model as jax_build
    arch, kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), **kw)
    japi = jax_build(jcfg, max_seq=S)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(seed)))
    if jcfg.use_bias:
        # the initializer's zero biases would hide the bias gradients'
        # path through the forward
        attn = jp["blocks"]["attn"]
        for i, b in enumerate(("bq", "bk", "bv")):
            attn[b] = 0.5 * jax.random.normal(jax.random.PRNGKey(10 + i),
                                              attn[b].shape, jnp.float32)
    tapi = build_model(tcfg, device="cpu", dtype=torch.float32)
    return japi, jp, tapi, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def jax_train_step(japi, **opt):
    """The reference's train step without a mesh: ``value_and_grad`` of
    its ``loss_fn`` and its ``adamw.update`` (runtime/steps.py:84-87)."""
    from repro.optim import adamw as jax_adamw
    cfg = jax_adamw.AdamWConfig(**opt)

    @jax.jit
    def step(params, opt_state, batch, i):
        loss, grads = jax.value_and_grad(japi.loss_fn)(params, batch)
        new_params, new_opt, gnorm = jax_adamw.update(cfg, grads, opt_state,
                                                      i)
        return loss, new_params, new_opt, gnorm

    return step


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def assert_grads_close(tgrads, jgrads, rel=GRAD_REL):
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        g = np.asarray(g)
        got = _leaf(tgrads, path).detach().numpy()
        err = float(np.abs(got - g).max())
        assert err <= rel * float(np.abs(g).max()), \
            (jax.tree_util.keystr(path), err, float(np.abs(g).max()))


def assert_params_close(tparams, jparams, steps):
    """Every element within twice the learning rates summed over the
    ``steps`` taken (an Adam step moves an element by about lr at most),
    and 95% of each leaf's elements within 1e-5."""
    cfg = AdamWConfig(**OPT)
    bound = 2 * sum(float(adamw.schedule(cfg, i)) for i in steps)
    for path, a in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        a = np.asarray(a)
        d = np.abs(_leaf(tparams, path).detach().numpy() - a)
        name = jax.tree_util.keystr(path)
        assert d.max() <= bound, (name, d.max(), bound)
        assert (d <= 1e-5).mean() >= 0.95, (name, (d > 1e-5).sum(), d.size)


# ---------------------------------------------------------------------------
# prefill attention under autograd
# ---------------------------------------------------------------------------
ATTN = {"gqa4-ragged": (2, 37, 8, 2, 16, 0),
        "gqa4-window": (2, 37, 8, 2, 16, 9),
        "rep4-d32": (1, 64, 4, 1, 32, 0),
        "mha-window": (2, 29, 2, 2, 16, 5)}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention_function_grads_equal_jax(case):
    """dq, dk, dv through ``L.chunked_attention`` with grads required (the
    Function: kernel forward on a card, plain backward) against
    ``jax.grad`` of the reference's ``chunked_attention``; atol = rtol =
    1e-5."""
    from repro.models import layers as JL
    b, s, h, kvh, d, window = ATTN[case]
    rng = np.random.RandomState(7)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    do = rng.randn(b, s, h, d).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(JL.chunked_attention(q, k, v, causal=True,
                                            window=window) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = L.chunked_attention(*ts, causal=True, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("sq,sk,off,window", [(13, 13, 0, 0), (8, 45, 37, 0),
                                               (12, 40, 28, 7)])
def test_attention_backward_equals_autograd_of_the_plain_forward(sq, sk, off,
                                                                 window):
    """``ref.flash_attention_bwd_ref`` (P recomputed, delta = rowsum(dO·O),
    dK and dV summed over each query group) against autograd of the plain
    forward (KV heads repeated), with a query offset and keys past the
    queries (the chunked-prefill shape); both compute in f32, so atol 2e-6
    + rtol 1e-5 (sums in other orders)."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               .requires_grad_()
               for s in ((2, sq, 6, 8), (2, sk, 2, 8), (2, sk, 2, 8)))
    do = torch.from_numpy(rng.randn(2, sq, 6, 8).astype(np.float32))
    with torch.no_grad():
        o = ops.flash_attention(q, k, v, causal=True, window=window,
                                q_offset=off)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True,
                                      window=window, q_offset=off)
    rep = 3
    out = ref.flash_attention_ref(
        q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
        v.repeat_interleave(rep, 2).transpose(1, 2), causal=True,
        window=window, q_offset=off).transpose(1, 2)
    want = torch.autograd.grad(out, (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-6, rtol=1e-5)


def test_kernel_refuses_to_drop_a_gradient(monkeypatch):
    """On a CUDA tensor the kernel's output has no autograd graph:
    ``ops.flash_attention`` raises when autograd records through inputs
    that require grad, unless the Function calls it (grad mode is off in
    its forward). Checked on the CPU by the check itself and by a CUDA
    path whose tensors claim to live on the card."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        ops.refuse_untracked_grad("flash_attention", x)
    with torch.no_grad():
        ops.refuse_untracked_grad("flash_attention", x)
    ops.refuse_untracked_grad("flash_attention", x.detach())

    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    k = torch.zeros(1, 4, 2, 16)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        with pytest.raises(RuntimeError, match="FlashAttentionFn"):
            ops.flash_attention(q, k, k)
    # inside the Function's forward grad mode is off, so the check that
    # guards the launch passes there
    plain = ops.flash_attention
    checked = []

    def guarded(q, k, v, **kw):
        ops.refuse_untracked_grad("flash_attention", q, k, v)
        checked.append(True)
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", guarded)
    out = ops.flash_attention_train(q, k, k)
    assert checked and out.requires_grad


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk,masked", [(32, 512, False), (48, 16, True),
                                            (40, 16, False)])
def test_chunked_softmax_xent_equals_reference(s, chunk, masked):
    """Value (rtol 1e-6) and gradients in h and the head (atol 1e-6 + rtol
    1e-5) against the reference's ``chunked_softmax_xent``, with the
    reference's chunking (S = 40 with chunk 16 falls back to 8)."""
    from repro.models import layers as JL
    rng = np.random.RandomState(s)
    h = rng.randn(3, s, 16).astype(np.float32)
    w = (0.3 * rng.randn(16, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (3, s)).astype(np.int32)
    mask = (rng.rand(3, s) < 0.7).astype(np.float32) if masked else None

    def f(h, w):
        return JL.chunked_softmax_xent(h, w, labels, chunk=chunk,
                                       label_mask=mask)

    jl, (jh, jw) = jax.value_and_grad(f, argnums=(0, 1))(h, w)
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tl = L.chunked_softmax_xent(
        th, tw, torch.from_numpy(labels), chunk=chunk,
        label_mask=None if mask is None else torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for t, j in ((th, jh), (tw, jw)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_equal_reference(f32, variant):
    """``loss_fn`` (rtol 1e-5) and the gradient of every parameter (within
    5e-4 of the leaf's largest) against the reference's, dense, GQA and
    reduced qwen2-moe (capacity dropping, biases drawn nonzero)."""
    japi, jp, tapi, tp = models(variant)
    b = SyntheticTokenStream(tapi.cfg.vocab_size, B, S, seed=1).batch_at(0)
    jl, jg = jax.value_and_grad(japi.loss_fn)(jp, jbatch(b))
    tracked = jax.tree.map(lambda t: t.requires_grad_(), tp)
    tl = tapi.loss_fn(tracked, tbatch(b))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert_grads_close(jax.tree.map(lambda t: t.grad, tracked), jg)


@pytest.mark.parametrize("variant", ["gqa", "moe"])
def test_remat_repeats_the_bits_and_runs_attention_twice(variant,
                                                        monkeypatch):
    """With ``remat`` each block's forward runs again in the backward: the
    flash forward runs 2 x num_layers times a step and its backward
    num_layers times, and loss and grads equal remat off bit for bit."""
    _, _, tapi, tp = models(variant)
    cfg = tapi.cfg
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.flash_attention, ref.flash_attention_bwd_ref

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", count_fwd)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", count_bwd)
    b = tbatch(SyntheticTokenStream(cfg.vocab_size, B, S, seed=2).batch_at(0))
    out = {}
    for remat in (True, False):
        api = build_model(cfg, device="cpu", dtype=torch.float32, remat=remat)
        calls.update(fwd=0, bwd=0)
        tracked = jax.tree.map(lambda t: t.detach().requires_grad_(), tp)
        loss = api.loss_fn(tracked, b)
        loss.backward()
        n = cfg.num_layers
        assert calls == {"fwd": (2 if remat else 1) * n, "bwd": n}, calls
        out[remat] = (loss, jax.tree.map(lambda t: t.grad, tracked))
    assert torch.equal(out[True][0], out[False][0])
    for a, c in zip(jax.tree.leaves(out[True][1]),
                    jax.tree.leaves(out[False][1])):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# steps against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["dense", "gqa"])
def test_three_adamw_steps_equal_reference(f32, variant):
    japi, jp, tapi, tp = models(variant)
    jstep = jax_train_step(japi, **OPT)
    from repro.optim import adamw as jax_adamw
    js = jax_adamw.init(jp)
    tstep = make_train_step(tapi, AdamWConfig(**OPT),
                            ShapeConfig("t", S, B, "train"), device="cpu")
    ts = adamw.init(tp)
    data = SyntheticTokenStream(tapi.cfg.vocab_size, B, S, seed=1)
    for i in range(3):
        b = data.batch_at(i)
        jl, jp, js, jn = jstep(jp, js, jbatch(b), i)
        tl, tp, ts, tn = tstep(tp, ts, b, i)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-3)
    assert_params_close(tp, jp, range(3))
    assert_params_close(ts.master, js.master, range(3))


def test_moe_steps_equal_reference_from_its_state(f32):
    japi, jp, tapi, _ = models("moe")
    jstep = jax_train_step(japi, **OPT)
    from repro.optim import adamw as jax_adamw
    js = jax_adamw.init(jp)
    tstep = make_train_step(tapi, AdamWConfig(**OPT),
                            ShapeConfig("t", S, B, "train"), device="cpu")
    data = SyntheticTokenStream(tapi.cfg.vocab_size, B, S, seed=1)
    for i in range(3):
        b = data.batch_at(i)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
        jl, jp, js, jn = jstep(jp, js, jbatch(b), i)
        tl, tp, ts, tn = tstep(tp, ts, b, i)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-3)
        assert_params_close(tp, jp, [i])


def test_train_step_checks_device_and_shape():
    _, _, tapi, tp = models("dense")
    step = make_train_step(tapi, AdamWConfig(**OPT),
                           ShapeConfig("t", S, B, "train"), device="cpu")
    bad = SyntheticTokenStream(tapi.cfg.vocab_size, B, S + 1).batch_at(0)
    with pytest.raises(ValueError, match="shape"):
        step(tp, adamw.init(tp), bad, 0)
    meta = build_model(tapi.cfg, device="cpu")
    meta.device = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        make_train_step(meta, AdamWConfig(), ShapeConfig("t", S, B, "train"),
                        device="cpu")


# ---------------------------------------------------------------------------
# the reference's tests/test_train_loop.py on the port
# ---------------------------------------------------------------------------
LOOP_OPT = AdamWConfig(**OPT)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu")               # bf16, as there
    shape = ShapeConfig("t", S, B, "train")
    return api, cfg, make_train_step(api, LOOP_OPT, shape, device="cpu")


def _fresh(api):
    params = api.init(torch.Generator().manual_seed(0))
    return params, adamw.init(params)


def test_loss_decreases():
    """The launcher (defaults: bf16, lr from --lr, warmup steps / 10, data
    of structure 0.9) lowers the loss by more than 1.0 in 40 steps."""
    out = train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "40",
                      "--batch", "4", "--seq", "32", "--lr", "3e-3",
                      "--device", "cpu"])
    losses = out["losses"]
    assert out["step"] == 40 and len(losses) == 40
    assert np.isfinite(losses).all() and np.isfinite(out["gnorms"]).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_checkpoint_resume_exact(setup, tmp_path):
    api, cfg, step = setup
    params, opt = _fresh(api)
    loopA = TrainLoop(train_step=step, params=params, opt_state=opt,
                      data=SyntheticTokenStream(cfg.vocab_size, B, S, seed=1),
                      cfg=TrainLoopConfig(total_steps=10))
    outA = loopA.run()

    ck = CheckpointManager(str(tmp_path), async_save=False)
    params, opt = _fresh(api)
    loopB1 = TrainLoop(train_step=step, params=params, opt_state=opt,
                       data=SyntheticTokenStream(cfg.vocab_size, B, S,
                                                 seed=1),
                       ckpt=ck, cfg=TrainLoopConfig(total_steps=5,
                                                    ckpt_every=5))
    loopB1.run()
    params2, opt2 = _fresh(api)   # junk state, must be overwritten
    loopB2 = TrainLoop(train_step=step, params=params2, opt_state=opt2,
                       data=SyntheticTokenStream(cfg.vocab_size, B, S,
                                                 seed=1),
                       ckpt=ck, cfg=TrainLoopConfig(total_steps=5))
    assert loopB2.try_restore()
    assert loopB2.step == 5
    outB = loopB2.run(5)

    for a, b in zip(jax.tree.leaves(loopA.params),
                    jax.tree.leaves(loopB2.params)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(loopA.opt_state),
                    jax.tree.leaves(loopB2.opt_state)):
        assert torch.equal(a, b)
    assert outA["losses"][5:] == outB["losses"]


def test_preemption_saves(setup, tmp_path):
    api, cfg, step = setup
    ck = CheckpointManager(str(tmp_path), async_save=False)
    params, opt = _fresh(api)
    loop = TrainLoop(train_step=step, params=params, opt_state=opt,
                     data=SyntheticTokenStream(cfg.vocab_size, B, S),
                     ckpt=ck, cfg=TrainLoopConfig(total_steps=100))
    loop.preempt()
    out = loop.run()
    assert out["preempted"]
    assert ck.latest_step() is not None


def test_sigterm_preempts_and_the_handler_is_put_back(setup, tmp_path):
    import signal
    api, cfg, step = setup
    ck = CheckpointManager(str(tmp_path), async_save=False)
    params, opt = _fresh(api)

    class Kill(SyntheticTokenStream):
        def __next__(self):
            if self.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().__next__()

    loop = TrainLoop(train_step=step, params=params, opt_state=opt,
                     data=Kill(cfg.vocab_size, B, S), ckpt=ck,
                     cfg=TrainLoopConfig(total_steps=10))
    before = signal.getsignal(signal.SIGTERM)
    previous = loop.install_signal_handler()
    try:
        out = loop.run()
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert previous is before and signal.getsignal(signal.SIGTERM) is before
    assert out["preempted"] and out["step"] == 3
    assert ck.latest_step() == 3
    assert ck.manifest(3)["extra"] == {"data": {"step": 3, "seed": 0},
                                       "step": 3}


def test_straggler_hook(setup):
    api, cfg, step = setup
    params, opt = _fresh(api)
    events = []

    class SlowData(SyntheticTokenStream):
        def __next__(self):
            if self.step == 6:
                time.sleep(3.0)   # inject a straggler step
            return super().__next__()

    loop = TrainLoop(train_step=step, params=params, opt_state=opt,
                     data=SlowData(cfg.vocab_size, B, S),
                     cfg=TrainLoopConfig(total_steps=9,
                                         straggler_factor=3.0),
                     on_straggler=lambda s, dt, ema: events.append(s))
    loop.run()
    assert events, "straggler not detected"


@pytest.mark.parametrize("flags,names", [
    (["--production-mesh"], "--production-mesh"),
    (["--mesh", "1x2", "--ckpt-dir", "unwritten"], "model axis")])
def test_launcher_refuses_meshes_by_name(flags, names):
    with pytest.raises(NotImplementedError, match=names) as e:
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                    *flags])
    assert "ROADMAP" in str(e.value)
    train.check_args(train.build_parser().parse_args(
        ["--arch", "x", "--mesh", "1x1"]))


# the launcher's meshes that run (they were refused before meshes ran over
# ranks), each against the plain one-device run of the same flags: alone,
# --multi-pod and --compress-pod-grads leave no pod axis and run the plain
# step, as the reference's launcher does (its default mesh is (1, 1) over
# data and model), so their losses are the plain run's bit for bit; a 2x1
# (data x model) mesh is data parallelism over two gloo ranks, the
# reference's GSPMD batch sharding, equal to one device within rtol 1e-5
SHORT = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps",
         "3", "--batch", "4", "--seq", "32", "--f32"]


@pytest.fixture(scope="module")
def plain_run():
    return train.main(SHORT)["losses"]


@pytest.mark.parametrize("flags,rtol", [
    (["--mesh", "2x1", "--backend", "gloo"], 1e-5),
    (["--multi-pod"], 0.0),
    (["--compress-pod-grads"], 0.0)])
def test_launcher_meshes_run_as_the_reference_does(plain_run, flags, rtol):
    losses = train.main(SHORT + flags)["losses"]
    assert len(losses) == 3
    if rtol:
        np.testing.assert_allclose(losses, plain_run, rtol=rtol)
    else:
        assert losses == plain_run
