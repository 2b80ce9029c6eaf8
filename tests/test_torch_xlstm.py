"""xLSTM on the port (``models/xlstm.py``) against the JAX package (CPU,
f32, reduced xlstm-125m: 2 (sLSTM, mLSTM) pairs, 4 heads x 16, d 64).

The same parameters (drawn by the JAX package, with the zero-initialized
mLSTM gate projections ``wi``/``wf`` and the sLSTM bias ``b`` drawn
nonzero there, carried across with ``params_from_jax``) and the same numpy
inputs go through both packages. Tolerances:

* the reference's own checks (``tests/test_xlstm.py``) on the port:
  chunkwise = stepwise and sLSTM decode = scan, atol 2e-4, rtol 2e-3;
* port against reference, f32 sums in another order: one mLSTM chunk, and
  every state a block returns, within 1e-5 of the leaf's largest |value|
  (measured: below 3e-6 at S = 1000); a block's or a pair's output within
  rtol 2e-3 (the reference's own rtol for the mLSTM) plus 1e-4 of its
  largest |value|, since h = num / max(|den|, exp(-m)) amplifies rounding
  where den nearly cancels (measured at S = 1000: the mLSTM's 1.5e-4 of
  the largest |value| and 1.8e-4 of the element itself, the pair's 5.2e-5
  of the largest); the model's logits and state leaves
  through two pairs and the head within 1e-4 of the largest |value| (the
  sLSTM's random recurrent weights amplify an ulp over steps: measured
  2e-5 on its h after 24 steps);
* the loss within rtol 1e-5 and every gradient within 5e-4 of its leaf's
  largest |value| (``test_torch_train.GRAD_REL``);
* engine streams equal, token for token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import xlstm as TX
from repro_torch.models.transformer import map_specs
from repro_torch.tree import leaves
from repro_torch.weights import cache_from_jax, params_from_jax
from test_torch_hymba import _engine, _jengine
from test_torch_timeline import ENGINE, _drive, _workload
from test_torch_timeline import steady_clock  # noqa: F401 (fixture)
from test_torch_train import assert_grads_close
from test_torch_vlm import _j, _t, f32, pair  # noqa: F401 (fixture)

ARCH = "xlstm-125m"
REF_TOL = dict(atol=2e-4, rtol=2e-3)
REL = 1e-5
MODEL_REL = 1e-4
OUT_RTOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(jparams, seed=7):
    """The JAX tree with the gate leaves the initializer zeroes drawn
    nonzero: the mLSTM's ``wi`` / ``wf`` and the sLSTM's bias ``b``."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if ("'mlstm'" in name and ("'wi'" in name or "'wf'" in name)) or \
                name.endswith("['slstm']['b']"):
            return jnp.asarray(0.2 * rng.randn(*x.shape), jnp.float32)
        return x
    return jax.tree_util.tree_map_with_path(draw, jparams)


@pytest.fixture(scope="module")
def xl(f32):
    japi, jparams, tapi, _ = pair(ARCH, max_seq=64, jit_init=True)
    jparams = _gates(jparams)
    return japi, jparams, tapi, params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _block_params(xl, kind):
    """Pair 0's ``kind`` ("slstm" / "mlstm") leaves in both packages."""
    _, jparams, _, tparams = xl
    jp = jax.tree.map(lambda a: a[0], jparams["pairs"][kind])
    tp = jax.tree.map(lambda a: a[0], tparams["pairs"][kind])
    return jp, tp


def _close(got, want, rel=REL, rtol=0.0):
    """``got`` (a tensor) within ``rel`` of ``want``'s largest |value|
    (and ``rtol`` of each element)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               rtol=rtol)


def _states_close(got, want, rel=REL):
    g, w = leaves(got), jax.tree.leaves(want)
    assert [tuple(t.shape) for t in g] == [a.shape for a in w]
    for a, b in zip(g, w):
        _close(a, b, rel)


def test_log_sigmoid_equals_jax_softplus_form():
    """``-softplus(-x)`` as JAX computes it (``logaddexp(x, 0)``), past
    torch's ``softplus`` threshold of 20 too, within 2 ulp (XLA's and
    torch's exp and log1p round apart by an ulp)."""
    x = np.concatenate([np.linspace(-60, 60, 241),
                        np.random.RandomState(0).randn(64) * 30]).astype(
        np.float32)
    want = np.asarray(-jax.nn.softplus(-jnp.asarray(x)))
    np.testing.assert_array_max_ulp(
        TX._log_sigmoid(torch.from_numpy(x)).numpy(), want, maxulp=2)


def test_mlstm_chunkwise_equals_stepwise(xl):
    """``tests/test_xlstm.py::test_mlstm_chunkwise_equals_stepwise`` on the
    port (its initializer's gates; S = 16, one chunk)."""
    from repro.configs import get_arch, reduced
    from repro.models import layers as JL
    from repro.models import xlstm as JX
    jcfg = reduced(get_arch(ARCH))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(
        lambda k: JL.init_params(k, JX.mlstm_specs(jcfg)))(
            jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    cfg = xl[2].cfg
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (2, 16, cfg.d_model), jnp.float32)))
    full, state_full = TX.mlstm_apply(cfg, tp, x, mode="train")
    state, outs = None, []
    for t in range(16):
        o, state = TX.mlstm_apply(cfg, tp, x[:, t:t + 1], mode="decode",
                                  state=state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **REF_TOL)
    for a, b in zip(state, state_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REF_TOL)


def test_slstm_decode_equals_scan(xl):
    """``tests/test_xlstm.py::test_slstm_decode_equals_scan`` on the port
    (the gates drawn nonzero)."""
    cfg = xl[2].cfg
    _, tp = _block_params(xl, "slstm")
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 8, cfg.d_model).astype(np.float32))
    full, state_full = TX.slstm_apply(cfg, tp, x, mode="train")
    state, outs = None, []
    for t in range(8):
        o, state = TX.slstm_apply(cfg, tp, x[:, t:t + 1], mode="decode",
                                  state=state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **REF_TOL)
    for a, b in zip(state, state_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REF_TOL)


def test_mlstm_chunk_equals_reference():
    """One chunk from a live state (m finite) and from a fresh one
    (m = -1e30, the masked decay's -inf and the clamped stabilizer)."""
    from repro.models import xlstm as JX
    rng = np.random.RandomState(3)
    B, c, H, dh = 2, 12, 4, 16
    q, k, v = (rng.randn(B, c, H, dh).astype(np.float32) for _ in range(3))
    logf = -np.abs(rng.randn(B, c, H)).astype(np.float32)
    logi = rng.randn(B, c, H).astype(np.float32)
    live = (rng.randn(B, H, dh, dh).astype(np.float32),
            rng.randn(B, H, dh).astype(np.float32),
            rng.randn(B, H).astype(np.float32))
    fresh = (np.zeros((B, H, dh, dh), np.float32),
             np.zeros((B, H, dh), np.float32),
             np.full((B, H), -1e30, np.float32))
    for st in (live, fresh):
        jh, jst = jax.jit(JX._mlstm_chunk)(
            *map(jnp.asarray, (q, k, v, logf, logi)),
            tuple(map(jnp.asarray, st)))
        th, tst = TX._mlstm_chunk(*map(torch.from_numpy,
                                       (q, k, v, logf, logi)),
                                  tuple(map(torch.from_numpy, st)))
        _close(th, jh)
        _states_close(tst, jst)


@pytest.mark.parametrize("S,chunk", [(16, 16), (40, 40), (1000, 8)])
def test_blocks_and_pair_equal_reference(xl, S, chunk):
    """``mlstm_apply`` (train over ``pick_chunk(S, 256)`` chunks, then one
    decode step from its state), ``slstm_apply`` (the scan, then a decode
    step) and the pair, outputs and states."""
    from repro.models import layers as JL
    from repro.models import xlstm as JX
    assert JL.pick_chunk(S, JX.CHUNK) == chunk
    japi, jparams, tapi, tparams = xl
    cfg, jcfg = tapi.cfg, japi.cfg
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    for kind, tf, jf in (("mlstm", TX.mlstm_apply, JX.mlstm_apply),
                         ("slstm", TX.slstm_apply, JX.slstm_apply)):
        jp, tp = _block_params(xl, kind)
        jo, jst = jax.jit(functools.partial(jf, jcfg, mode="train"))(
            jp, jnp.asarray(x))
        to, tst = tf(cfg, tp, torch.from_numpy(x), mode="train")
        _close(to, jo, MODEL_REL, OUT_RTOL)
        _states_close(tst, jst)
        carried = tuple(torch.from_numpy(np.array(a)) for a in jst)
        jo, jst = jax.jit(functools.partial(jf, jcfg, mode="decode"))(
            jp, jnp.asarray(x1), state=jst)
        to, tst = tf(cfg, tp, torch.from_numpy(x1), mode="decode",
                     state=carried)
        _close(to, jo, MODEL_REL, OUT_RTOL)
        _states_close(tst, jst)
    jp = jax.tree.map(lambda a: a[1], jparams["pairs"])
    tp = jax.tree.map(lambda a: a[1], tparams["pairs"])
    jo, jst = jax.jit(functools.partial(
        JX.pair_apply, jcfg, positions=None, mode="prefill", cache=None,
        cache_len=None))(jp, jnp.asarray(x))
    to, tst = TX.pair_apply(cfg, tp, torch.from_numpy(x), mode="train")
    _close(to, jo, MODEL_REL, OUT_RTOL)
    _states_close(tst, jst)


def test_model_equals_reference(xl):
    """``prefill_fn`` (logits, every state leaf, ``len``), four
    ``decode_fn`` steps from the reference's cache carried across by
    ``cache_from_jax``, and from ``init_cache`` (every leaf zero, the
    stabilizers m = 0, as the engine's per-token prefill starts)."""
    japi, jparams, tapi, tparams = xl
    cfg = tapi.cfg
    rng = np.random.RandomState(4)
    B, S = 2, 24
    jdecode = jax.jit(japi.decode_fn)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, MODEL_REL)
    assert sorted(tc) == sorted(jc) == ["len", "pairs"]
    assert int(tc["len"]) == int(jc["len"]) == S
    _states_close(tc["pairs"], jc["pairs"], MODEL_REL)
    for jcache, tcache in (
            (jc, cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")),
            (japi.init_cache(B), tapi.init_cache(B))):
        assert float(leaves(tcache["pairs"])[-1].abs().max()) >= 0
        for _ in range(4):
            nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            jl, jcache = jdecode(jparams, jcache,
                                        {"tokens": jnp.asarray(nxt)})
            tl, tcache = tapi.decode_fn(tparams, tcache,
                                        {"tokens": torch.from_numpy(nxt)})
            _close(tl, jl, MODEL_REL)
        _states_close(tcache["pairs"], jcache["pairs"], MODEL_REL)
        assert int(tcache["len"]) == int(jcache["len"])


def test_init_cache_starts_m_at_zero_and_prefill_at_minus_1e30(xl):
    """The two starts of the stabilizer, both the reference's: a zero
    ``init_cache`` (m = 0) and a fresh state (m = -1e30); from the same
    token they give different logits."""
    _, _, tapi, tparams = xl
    cache = tapi.init_cache(1)
    assert all(float(t.abs().max()) == 0 for t in leaves(cache["pairs"]))
    tok = torch.tensor([[5]])
    dec, _ = tapi.decode_fn(tparams, cache, {"tokens": tok})
    pre, pc = tapi.prefill_fn(tparams, {"tokens": tok})
    assert float(pc["pairs"][1][2].min()) > -1e29     # m after one step
    assert float((dec - pre).abs().max()) > 0


def test_loss_and_grads_equal_reference(xl):
    """``loss_fn`` under remat and every gradient against
    ``jax.value_and_grad`` of the reference's."""
    japi, jparams, tapi, tparams = xl
    rng = np.random.RandomState(6)
    toks = rng.randint(0, tapi.cfg.vocab_size, (2, 16)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, jg = jax.jit(jax.value_and_grad(japi.loss_fn))(jparams, _j(b))
    tracked = jax.tree.map(lambda t: t.detach().clone().requires_grad_(),
                           tparams)
    tl = tapi.loss_fn(tracked, _t(b))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert_grads_close(jax.tree.map(lambda t: t.grad, tracked), jg)


def test_cache_tree_and_dtypes(xl):
    """The cache tree of the reference's ``pair_cache_spec``: f32 state
    by default; under ``cache_quant`` the states in bf16 but for the
    mLSTM's stabilizer m, in f32; ``prefill_fn`` still returns f32 state
    and ``decode_fn`` keeps each leaf's type."""
    from repro.models.api import build_model as jax_build
    from repro_torch.models.api import build_model
    japi, jparams, tapi, tparams = xl
    B, H, dh = 2, tapi.cfg.num_heads, tapi.cfg.head_dim
    n = tapi.cfg.num_layers // 2
    for quant in (False, True):
        api = build_model(tapi.cfg, device="cpu", dtype=torch.float32,
                          max_seq=64, cache_quant=quant)
        jq = jax_build(japi.cfg, max_seq=64, cache_quant=quant)
        specs = api.init_cache_specs(B)
        jspecs, _ = jq.init_cache_specs(B)
        got = []
        map_specs(got.append, specs["pairs"])
        tl = jax.tree.leaves(jspecs["pairs"])
        assert [s for s, _ in got] == [tuple(a.shape) for a in tl]
        assert [str(d).split(".")[-1] for _, d in got] == \
            [a.dtype.name for a in tl]
        bf = torch.bfloat16 if quant else torch.float32
        assert [d for _, d in got] == [bf] * 6 + [torch.float32]
        assert [s for s, _ in got][4:] == [(n, B, H, dh, dh), (n, B, H, dh),
                                           (n, B, H)]
        _, pc = api.prefill_fn(tparams, {"tokens": torch.zeros(
            (B, 4), dtype=torch.long)})
        assert all(t.dtype == torch.float32 for t in leaves(pc["pairs"]))
        cache = api.init_cache(B)
        api.decode_fn(tparams, cache, {"tokens": torch.zeros(
            (B, 1), dtype=torch.long)})
        assert [t.dtype for t in leaves(cache["pairs"])] == \
            [d for _, d in got]


def test_engine_streams_equal_reference(xl, steady_clock):
    """The reference's local engine serves xLSTM on the timeline (per-token
    prefill from a zero cache, each slot's state copied into its row); the
    port's local engine, cold and warmed, gives its greedy streams, and
    the port's pipelined backend, unsealed, cold and warmed, its local
    ones (the reference's pipelined decoder cannot split two pairs: it
    plans over layers). Six requests over four slots: slots are reused."""
    japi, jparams, tapi, tparams = xl
    wl = _workload(11, 6, tapi.cfg.vocab_size, 16)
    jeng = _jengine(japi, jparams)
    assert jeng.kv_layout == "timeline"
    want = _drive(jeng, wl)
    for backend, kw in (("local", {}),
                        ("local", dict(warmup=True, allow_swap=False)),
                        ("pipelined", {}),
                        ("pipelined", dict(warmup=True))):
        eng = _engine(tapi, tparams, backend, **kw)
        assert eng.stats()["kv_layout"] == "timeline"
        assert eng.api.model.served_segment.name == "pairs"
        assert sum(eng.stage_blocks) == 2
        assert _drive(eng, wl) == want, (backend, kw)
        if kw.get("warmup"):
            st = eng.stats()
            assert st["warmed"] and st["post_warmup_compiles"] == 0


# every arch the port's engine serves but xLSTM (the engine refuses
# moonshot's two segments, Whisper's encoder-decoder and qwen2-vl's M-RoPE)
ONE_LAYER_BLOCKS = ("llama3.2-1b", "llama3.2-3b", "glm4-9b",
                    "qwen2-moe-a2.7b", "hymba-1.5b")


@pytest.mark.parametrize("arch", ONE_LAYER_BLOCKS)
def test_engine_plans_over_the_reference_profiles(arch):
    """The port's engine plans over one profile a block of the served
    segment (``block_profiles``). Where a block is one layer, as in every
    family the engine serves but xLSTM, those are the reference engine's
    profiles (``profiles_from_arch(cfg, seq_len=1)``) unchanged, so its
    recorded plan is the reference's; xLSTM's pairs are
    ``test_engine_plans_over_pairs``."""
    from repro.configs import get_arch as jget
    from repro.configs import reduced as jreduced
    from repro.core.planner import profiles_from_arch as jprofiles
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    api = build_model(reduced(get_arch(arch)), device="cpu",
                      dtype=torch.float32, max_seq=64)
    eng = _engine(api, api.init(torch.Generator().manual_seed(0)), "local")
    assert api.model.served_segment.n == api.cfg.num_layers
    want = jprofiles(jreduced(jget(arch)), seq_len=1)
    assert [dataclasses.astuple(p) for p in eng.profiles] == \
        [dataclasses.astuple(p) for p in want]


def test_engine_plans_over_pairs(xl):
    """xLSTM's engine plans over its pairs where the reference's plans over
    its layers: block b adds layers 2b and 2b + 1's FLOPs, parameter and
    activation bytes and keeps layer 2b + 1's output bytes and
    similarity."""
    from repro.core.planner import profiles_from_arch as jprofiles
    japi, _, tapi, tparams = xl
    eng = _engine(tapi, tparams, "local")
    layers = jprofiles(japi.cfg, seq_len=1)
    assert len(layers) == 2 * len(eng.profiles) == tapi.cfg.num_layers
    for b, got in enumerate(eng.profiles):
        pair = layers[2 * b:2 * b + 2]
        assert got.flops == sum(p.flops for p in pair)
        assert got.params_bytes == sum(p.params_bytes for p in pair)
        assert got.act_bytes == sum(p.traffic() for p in pair)
        assert got.out_bytes == pair[1].out_bytes
        assert got.similarity == pair[1].similarity


def test_sealed_pipelined_runs_the_seals(xl, steady_clock, monkeypatch):
    """Sealed stage boundaries: one seal and one unseal per microbatch per
    step at the pair boundary, every request done."""
    from repro_torch.kernels import ops
    _, _, tapi, tparams = xl
    calls = {"seal": 0, "unseal": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    eng = _engine(tapi, tparams, "pipelined", seal_boundary=True)
    _drive(eng, _workload(11, 6, tapi.cfg.vocab_size, 16))
    nm = ENGINE["num_microbatches"]
    assert calls["seal"] == calls["unseal"] == nm * eng.backend.steps > 0


def test_serve_cli_xlstm_reduced_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "4", "--max-new", "4", "--f32"])
    out = capsys.readouterr().out
    assert "arch=xlstm-125m-reduced" in out and "timeline:" in out
    assert "served 4 requests" in out
