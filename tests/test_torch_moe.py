"""The MoE family of the port against the JAX package's (CPU, f32).

``moe_mlp_apply`` (top-k routing, exclusive-cumsum slots, ``[E, C, D]``
dispatch, gated experts, shared experts, the Switch aux loss) must equal
the reference's within atol = rtol = 1e-5 on the same parameters and
inputs, without dropping (the serving path) and with capacity dropping
at factors 1.25 and 0.05; with one expert and top-1 it is one SwiGLU.
``capacity`` equals the reference's on a grid. Reduced qwen2-moe-a2.7b,
its attention biases drawn nonzero on the JAX side, gives the
reference's one-shot, packed and chunked prefill logits within atol =
rtol = 1e-4 (its engine's streams are held in
``tests/test_torch_configs.py``). The parameter counts the planner reads
equal the reference's for every registered config; moonshot-v1-16b-a3b,
whose dense stem block the reference's engine refuses to serve, is
refused by name. On the card, the dispatch's repeat and graph replay
are held in ``tests/test_torch_warmup.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ARCHS, ArchConfig, get_arch, reduced
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.models.moe import (CAPACITY_FACTOR, capacity, moe_mlp_apply,
                                    moe_mlp_specs)
from repro_torch.weights import params_from_jax
from test_torch_chunked_prefill import _chunk_chain
from test_torch_configs import _models

ARCH = "qwen2-moe-a2.7b"
MLP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
# keyword arguments of both packages' moe_mlp_apply
DISPATCH = {"no-drop": dict(drop_tokens=False),
            "drop-1.25": dict(capacity_factor=1.25),
            "drop-0.05": dict(capacity_factor=0.05)}


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


def _mlp(**kw):
    """Both packages' reduced qwen2-moe config (fields ``kw`` replaced),
    the reference's MoE FFN parameters in f32 and the port's copy."""
    from repro.models import layers as JL
    from repro.models import moe as JM
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCH)), **kw)
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), **kw)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JL.init_params(jax.random.PRNGKey(0),
                                     JM.moe_mlp_specs(jcfg)))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _x(cfg, B=2, S=64, seed=1):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_moe_mlp_apply_matches_reference(case):
    from repro.models import moe as JM
    jcfg, tcfg, jp, tp = _mlp()
    x = _x(tcfg)
    jout, jaux = JM.moe_mlp_apply(jcfg, jp, jnp.asarray(x), **DISPATCH[case])
    tout, taux = moe_mlp_apply(tcfg, tp, torch.from_numpy(x),
                               **DISPATCH[case])
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **MLP_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MLP_TOL)
    assert tout.dtype == torch.float32 and tout.shape == x.shape
    if case == "drop-0.05":
        # C = 8 slots for 32 decisions an expert on average: tokens drop
        full, _ = moe_mlp_apply(tcfg, tp, torch.from_numpy(x),
                                drop_tokens=False)
        assert not torch.allclose(full, tout, **MLP_TOL)
    # serving skips the aux loss and nothing else
    out, none = moe_mlp_apply(tcfg, tp, torch.from_numpy(x), aux=False,
                              **DISPATCH[case])
    assert none is None and torch.equal(out, tout)


@pytest.mark.parametrize("kw", [dict(capacity_factor=4.0),
                                dict(drop_tokens=False)],
                         ids=["drop-4.0", "no-drop"])
def test_single_expert_equals_swiglu(kw):
    """E=1, K=1, no shared experts, ample capacity: the MoE FFN is its one
    expert's SwiGLU (tests/test_moe.py), and the reference's result."""
    from repro.models import moe as JM
    jcfg, tcfg, jp, tp = _mlp(num_experts=1, num_experts_per_tok=1,
                              num_shared_experts=0)
    x = _x(tcfg, S=8)
    out, _ = moe_mlp_apply(tcfg, tp, torch.from_numpy(x), **kw)
    want = L.swiglu(torch.from_numpy(x).reshape(-1, tcfg.d_model),
                    tp["wi"][0], tp["wg"][0], tp["wo"][0])
    torch.testing.assert_close(out.reshape(-1, tcfg.d_model), want,
                               **MLP_TOL)
    jout, _ = JM.moe_mlp_apply(jcfg, jp, jnp.asarray(x), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MLP_TOL)


def test_capacity_and_specs_equal_reference():
    from repro.models import moe as JM
    assert CAPACITY_FACTOR == JM.CAPACITY_FACTOR
    for T in (1, 7, 8, 31, 128, 1000, 4096):
        for K in (1, 2, 4, 6):
            for E in (1, 8, 60, 64):
                for f in (0.05, 1.0, 1.25, 2.0):
                    assert capacity(T, K, E, f) == JM.capacity(T, K, E, f), \
                        (T, K, E, f)
    for cfg, jcfg in ((reduced(get_arch(ARCH)), jax_reduced(jax_get_arch(
            ARCH))), (get_arch(ARCH), jax_get_arch(ARCH))):
        got = jax.tree.map(lambda s: (s.shape, s.init, s.scale),
                           moe_mlp_specs(cfg),
                           is_leaf=lambda s: isinstance(s, L.ParamSpec))
        want = jax.tree.map(lambda s: (s.shape, s.init, s.scale),
                            JM.moe_mlp_specs(jcfg),
                            is_leaf=lambda s: hasattr(s, "axes"))
        assert got == want


@pytest.fixture(scope="module")
def qwen(f32):
    return _models(ARCH)


@pytest.mark.parametrize("mode", ["at", "packed", "chunk"])
def test_reduced_prefill_matches_reference(qwen, mode):
    japi, jparams, tapi, tparams = qwen
    assert np.abs(np.asarray(jparams["blocks"]["attn"]["bq"])).min() > 0
    rng = np.random.RandomState(7)
    if mode == "at":
        for P in (11, 5):
            toks = np.zeros((1, 16), np.int32)
            toks[0, :P] = rng.randint(0, 512, size=P)
            jl, jc = japi.prefill_at_fn(jparams, {
                "tokens": jnp.asarray(toks), "prompt_len": jnp.int32(P)})
            tl, tc = tapi.prefill_at_fn(tparams, {
                "tokens": torch.from_numpy(toks), "prompt_len": P})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            for part in range(2):
                np.testing.assert_allclose(
                    tc["blocks"][part][..., :P, :].numpy(),
                    np.asarray(jc["blocks"][part])[..., :P, :], **TOL)
    elif mode == "packed":
        lens = [5, 8, 3, 1]                   # the last row: a dummy of 1
        toks = np.zeros((4, 8), np.int32)
        for b, n in enumerate(lens):
            toks[b, :n] = rng.randint(0, 512, size=n)
        tl, tc = tapi.prefill_packed_fn(tparams, {
            "tokens": torch.from_numpy(toks), "prompt_lens": np.array(lens)})
        jl, jc = japi.prefill_packed_fn(jparams, {
            "tokens": jnp.asarray(toks), "prompt_lens": jnp.asarray(lens)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for b, n in enumerate(lens):
            for part in range(2):
                np.testing.assert_allclose(
                    tc["blocks"][part][:, b, :, :n].numpy(),
                    np.asarray(jc["blocks"][part])[:, b, :, :n], **TOL)
    else:
        N, Pg, C = 12, 4, 5
        prompt = rng.randint(0, 512, size=13).tolist()
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
                                       np.asarray(jpools["blocks"][part]),
                                       **TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_parameter_counts_equal_reference(name):
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    assert cfg.total_params() == jcfg.total_params()
    assert cfg.total_active_params() == jcfg.total_active_params()
    assert cfg.embed_params() == jcfg.embed_params()
    for i in range(cfg.num_layers):
        assert cfg.block_params(i) == jcfg.block_params(i)
        assert cfg.block_active_params(i) == jcfg.block_active_params(i)
    if name == ARCH:
        assert cfg.total_params() == 14_315_587_584
        # the port's init draws what the count names, plus the attention
        # biases, which the reference's count leaves out
        r = reduced(cfg)
        api = build_model(r, device="cpu", dtype=torch.float32)
        n = sum(t.numel() for t in jax.tree.leaves(
            api.init(torch.Generator().manual_seed(0))))
        assert n == r.total_params() + r.num_layers * (
            r.num_heads + 2 * r.num_kv_heads) * r.head_dim


def test_moonshot_refused_by_name():
    """moonshot-v1-16b-a3b has a dense stem block ahead of its MoE blocks:
    two segments. The port registers and builds it (``stem`` + ``blocks``,
    as the reference's ``build_moe``), ``pipeline_applicable`` is False as
    in the reference, and the engine, and so ``serve``, refuse it by name,
    as the reference's engine refuses to serve it."""
    from repro_torch.runtime.pipeline import pipeline_applicable
    from repro_torch.serving import EngineConfig, ServingEngine
    name = "moonshot-v1-16b-a3b"
    jcfg = jax_get_arch(name)
    cfg = get_arch(name)
    assert all(getattr(cfg, f.name) == getattr(jcfg, f.name)
               for f in dataclasses.fields(ArchConfig))
    assert cfg.total_params() == jcfg.total_params()
    api = build_model(reduced(cfg), device="cpu", dtype=torch.float32)
    assert [s.name for s in api.model.segments] == ["stem", "blocks"]
    assert not pipeline_applicable(api)
    with pytest.raises(ValueError, match=f"{name}-reduced: serving needs "
                                         f"a single homogeneous segment"):
        ServingEngine(api, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="single homogeneous segment"):
        serve.main(["--arch", name, "--reduced", "--device", "cpu"])