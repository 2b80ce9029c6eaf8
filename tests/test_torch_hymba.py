"""Hymba on the port (``models/hymba.py``) against the JAX package (CPU,
f32, reduced hymba-1.5b: 4 layers, 4 heads over 4 KV heads, head_dim 16,
SSM state 8, window 32).

The same parameters (drawn by the JAX package, the zero-initialized
``conv_b``, ``dt_bias`` and ``a_log`` drawn nonzero there, carried
across with ``params_from_jax``) and the same numpy inputs go through
both packages. Tolerances: the selective scan within atol = rtol = 1e-5
of the reference's and of a plain step-by-step loop (the port scans each
chunk by ``jax.lax.associative_scan``'s odd-even recursion, so its
products associate as XLA's; measured differences are below 1e-6 on
values up to 6); ``mamba_apply`` within 1e-5; the reference's own train
= decode-chain check at its tolerances (atol 3e-4, rtol 3e-3); the
model's loss within 1e-5, logits within atol = rtol = 1e-4 and each
cache leaf within 1e-4 of its largest |value|; prefill S - 1 then decode
one = prefill S within 1e-4 of the largest logit. The engine serves
Hymba on the timeline (rolling KV, conv window and SSM state in each
slot's row): its greedy streams equal the reference engine's, local and
pipelined, cold and warmed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import hymba as TH
from repro_torch.weights import cache_from_jax, params_from_jax
from test_torch_timeline import ENGINE, _drive, _workload
from test_torch_vlm import _j, _t, f32, pair  # noqa: F401 (fixture)

ARCH = "hymba-1.5b"
TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hymba(f32):
    return pair(ARCH, max_seq=64)


@pytest.mark.parametrize("S", [512, 808])
def test_ssm_scan_chunked_equals_reference_and_loop(S):
    """S = 512: chunks of 256, the state crosses a chunk boundary; S = 808
    = 101 x 8: ``pick_chunk`` halves the chunk down to 8."""
    from repro.models import hymba as JH
    from repro_torch.models.layers import pick_chunk
    assert pick_chunk(S, TH.SSM_CHUNK) == {512: 256, 808: 8}[S]
    rng = np.random.RandomState(S)
    g = rng.uniform(0.3, 1.0, (2, S, 6, 4)).astype(np.float32)
    u = rng.randn(2, S, 6, 4).astype(np.float32)
    h0 = rng.randn(2, 6, 4).astype(np.float32)
    hs, hT = TH._ssm_scan_chunked(torch.from_numpy(g), torch.from_numpy(u),
                                  torch.from_numpy(h0))
    jhs, jhT = JH._ssm_scan_chunked(jnp.asarray(g), jnp.asarray(u),
                                    jnp.asarray(h0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), **SCAN_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), **SCAN_TOL)
    h, loop = torch.from_numpy(h0), []
    for t in range(S):
        h = torch.from_numpy(g[:, t]) * h + torch.from_numpy(u[:, t])
        loop.append(h)
    np.testing.assert_allclose(hs.numpy(), torch.stack(loop, 1).numpy(),
                               **SCAN_TOL)
    assert torch.equal(hT, hs[:, -1])


def _mamba(seed=0):
    """(cfg, port params, reference params) of one reduced Mamba head
    group, f32, the zero-initialized leaves drawn nonzero."""
    from repro.configs import get_arch, reduced
    from repro.models import hymba as JH
    from repro.models import layers as JL
    cfg = reduced(get_arch(ARCH))
    p = JL.init_params(jax.random.PRNGKey(seed), JH.mamba_specs(cfg))
    rng = np.random.RandomState(seed)
    p = {k: (jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32)
             if k in ("conv_b", "dt_bias", "a_log") else
             v.astype(jnp.float32)) for k, v in p.items()}
    return cfg, params_from_jax(jax.tree.map(np.asarray, p), "cpu"), p


def test_mamba_apply_train_and_decode_equal_reference():
    from repro.models import hymba as JH
    from repro_torch.configs import get_arch, reduced
    jcfg, tp, jp = _mamba()
    cfg = reduced(get_arch(ARCH))
    rng = np.random.RandomState(3)
    B, S, d, n, k = 2, 40, cfg.d_model, cfg.ssm_state, cfg.conv_kernel
    h = rng.randn(B, S, d).astype(np.float32)
    for state in (None, (rng.randn(B, k - 1, d).astype(np.float32),
                         rng.randn(B, d, n).astype(np.float32))):
        jy, (jconv, jssm) = JH.mamba_apply(
            jcfg, jp, jnp.asarray(h), mode="train",
            state=None if state is None else tuple(map(jnp.asarray, state)))
        ty, (tconv, tssm) = TH.mamba_apply(
            cfg, tp, torch.from_numpy(h), mode="train",
            state=None if state is None else tuple(map(torch.from_numpy,
                                                       state)))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
        np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
        np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm),
                                   **SCAN_TOL)
    state = (rng.randn(B, k - 1, d).astype(np.float32),
             rng.randn(B, d, n).astype(np.float32))
    jy, (jconv, jssm) = JH.mamba_apply(jcfg, jp, jnp.asarray(h[:, :1]),
                                       mode="decode",
                                       state=tuple(map(jnp.asarray, state)))
    ty, (tconv, tssm) = TH.mamba_apply(cfg, tp, torch.from_numpy(h[:, :1]),
                                       mode="decode",
                                       state=tuple(map(torch.from_numpy,
                                                       state)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **SCAN_TOL)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), **SCAN_TOL)


def test_mamba_train_equals_decode_chain():
    """The reference's ``tests/test_mamba.py`` on the port: the prefill
    conv (``F.conv1d``, groups = di) and decode's window sum agree at
    every step, and the chunked scan equals the stepwise recurrence."""
    from repro_torch.configs import get_arch, reduced
    _, p, _ = _mamba()
    cfg = reduced(get_arch(ARCH))
    B, S = 2, 12
    h = torch.from_numpy(np.random.RandomState(1).randn(
        B, S, cfg.d_model).astype(np.float32))
    full, (conv_f, ssm_f) = TH.mamba_apply(cfg, p, h, mode="train")
    k = cfg.conv_kernel
    conv_state = torch.zeros(B, k - 1, cfg.d_model)
    ssm_state = torch.zeros(B, cfg.d_model, cfg.ssm_state)
    outs = []
    for t in range(S):
        o, (conv_state, ssm_state) = TH.mamba_apply(
            cfg, p, h[:, t:t + 1], mode="decode",
            state=(conv_state, ssm_state))
        outs.append(o)
    step = torch.cat(outs, dim=1)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=3e-4,
                               rtol=3e-3)
    np.testing.assert_allclose(ssm_state.numpy(), ssm_f.numpy(), atol=3e-4,
                               rtol=3e-3)
    # the conv window holds the last k-1 projected inputs (one-token and
    # whole-sequence GEMMs round apart by an ulp)
    np.testing.assert_allclose(conv_state.numpy(), conv_f.numpy(),
                               **SCAN_TOL)


def _close(got, want):
    """A cache leaf within 1e-4 of its largest |value|: the random init's
    states grow to thousands after a few blocks (ROADMAP §3)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_hymba_model_equals_reference(hymba):
    """``loss_fn``, ``prefill_fn`` at S = 40 (the window of 32 bites: its
    KV rolls into the buffer) and four ``decode_fn`` steps from the
    reference's cache, through ``cache_from_jax``'s nested tree."""
    japi, jparams, tapi, tparams = hymba
    cfg = tapi.cfg
    rng = np.random.RandomState(4)
    B, S = 2, 40
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    np.testing.assert_allclose(float(tapi.loss_fn(tparams, _t(b))),
                               float(japi.loss_fn(jparams, _j(b))),
                               atol=1e-5, rtol=1e-5)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    from repro_torch.tree import leaves
    got, want = leaves(tc["blocks"]), jax.tree.leaves(jc["blocks"])
    assert [tuple(t.shape) for t in got] == [w.shape for w in want] == [
        (4, B, 4, 32, 16), (4, B, 4, 32, 16), (4, B, 3, 64), (4, B, 64, 8)]
    for a, w in zip(got, want):
        _close(a, w)
    jcache = jc
    tcache = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for _ in range(4):
        nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = japi.decode_fn(jparams, jcache,
                                    {"tokens": jnp.asarray(nxt)})
        tl, tcache = tapi.decode_fn(tparams, tcache,
                                    {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, w in zip(leaves(tcache["blocks"]),
                    jax.tree.leaves(jcache["blocks"])):
        _close(a, w)
    jh = np.asarray(japi.model.hidden_states_fn(jparams,
                                                {"tokens": jnp.asarray(toks)}))
    th = tapi.model.hidden_states_fn(tparams,
                                     {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-4 * np.abs(jh).max(),
                               rtol=0)


@pytest.mark.parametrize("S", [24, 40])
def test_decode_after_prefill_equals_prefill(hymba, S):
    """``tests/test_models_smoke.py::test_decode_consistent_with_prefill``
    on the port: prefill S - 1 tokens, decode token S - 1, against the
    prefill of all S; at S = 40 the rolling window has wrapped."""
    _, _, tapi, tparams = hymba
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, tapi.cfg.vocab_size, (2, S)))
    full, _ = tapi.prefill_fn(tparams, {"tokens": toks})
    _, cache = tapi.prefill_fn(tparams, {"tokens": toks[:, :S - 1]})
    dec, cache = tapi.decode_fn(tparams, cache, {"tokens": toks[:, S - 1:]})
    scale = float(full.abs().max())
    assert float((dec - full).abs().max()) < 1e-4 * scale
    assert int(cache["len"]) == S


def test_swa_decode_evicts_oldest(hymba):
    """``tests/test_perf_features.py::test_swa_decode_evicts_oldest`` on
    the port: after a 32-token prefill and one decode step only slot 0 (the
    oldest token, absolute index 32 - 32) changed."""
    _, _, tapi, tparams = hymba
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tapi.cfg.vocab_size, (1, 32)))
    _, cache = tapi.prefill_fn(tparams, {"tokens": toks})
    k_before = cache["blocks"][0][0][0, 0].clone()          # [KVH, S, D]
    _, cache = tapi.decode_fn(tparams, cache,
                              {"tokens": torch.tensor([[7]])})
    k_after = cache["blocks"][0][0][0, 0]
    changed = ((k_after - k_before).abs().amax(dim=(0, 2)) > 1e-6).nonzero()
    assert changed.flatten().tolist() == [0]


def _jengine(japi, jparams, **kw):
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    return JEngine(japi, config=JCfg(**{**ENGINE, **kw}), params=jparams,
                   backend="local")


def _engine(tapi, tparams, backend, **kw):
    from repro_torch.serving import EngineConfig, ServingEngine
    return ServingEngine(tapi, EngineConfig(**{**ENGINE, **kw}), tparams,
                         device="cpu", backend=backend)


def test_engine_streams_equal_reference(hymba):
    """The reference's local engine lands Hymba on the timeline; the
    port's local and unsealed pipelined backends give its greedy streams,
    and a warmed engine the cold one's. Prompts up to 40 tokens against a
    window of 32, six requests over four slots: slots are reused, each
    from its own prefill's conv and SSM state."""
    japi, jparams, tapi, tparams = hymba
    wl = _workload(11, 6, tapi.cfg.vocab_size, 40)
    jeng = _jengine(japi, jparams, prompt_capacity=40)
    assert jeng.kv_layout == "timeline"
    want = _drive(jeng, wl)
    for backend in ("local", "pipelined"):
        eng = _engine(tapi, tparams, backend, prompt_capacity=40)
        assert eng.stats()["kv_layout"] == "timeline"
        assert _drive(eng, wl) == want, backend
    warm = _engine(tapi, tparams, "local", prompt_capacity=40, warmup=True,
                   allow_swap=False)
    assert _drive(warm, wl) == want
    st = warm.stats()
    assert st["warmed"] and st["post_warmup_compiles"] == 0


def test_serve_cli_hymba_reduced_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--backend", "local", "--requests", "4", "--max-new", "4",
                "--f32", "--warmup", "--assert-no-recompile"])
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b-reduced" in out and "timeline:" in out
    assert "served 4 requests" in out and "NO-RECOMPILE OK" in out
