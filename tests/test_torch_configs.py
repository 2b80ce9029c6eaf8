"""The port's configs against the JAX package's (CPU, f32).

llama3.2-3b, glm4-9b and command-r-35b are the reference's dense configs
that ``StackedLM`` serves (RoPE, full attention, no bias), qwen2-moe-a2.7b
its MoE config (attention biases, 60 experts top-4 plus 4 shared; reduced:
8 experts top-2 plus 1 shared). Their fields, and those of their
``reduced`` forms, must equal the reference's. On the same parameters
(drawn by the JAX package, attention biases drawn nonzero there, and
carried across with ``params_from_jax``, untied heads included), each
reduced model's prefill logits agree within atol = rtol = 1e-4 (f32 sums
in another order) and its engine's greedy streams and paging decisions
under swap preemption equal the reference engine's. ``reduced`` keeps at
most 4
heads, so two variants restore the full configs' grouping: rep 3
(llama3.2-3b: 6 query heads over 2 KV heads) and rep 16 over 2 KV heads
with an untied head (glm4-9b: 32 query heads). The reference's input-shape
cells (``SHAPES``, ``get_shape``, ``shape_applicable``) and its analytic
FLOP and byte model (``utils/analytic_cost.estimate``) must give the
reference's values exactly for every registered config and shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax, tensor_from_numpy
from test_torch_engine import _both
from test_torch_serving import _workload

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ["llama3.2-3b", "glm4-9b", "command-r-35b", "qwen2-moe-a2.7b"]
# name -> (arch, fields replaced on both packages' reduced config)
VARIANTS = {
    "llama3.2-3b": ("llama3.2-3b", {}),
    "glm4-9b": ("glm4-9b", {}),
    "command-r-35b": ("command-r-35b", {}),
    "llama3.2-3b-rep3": ("llama3.2-3b", dict(num_heads=6, num_kv_heads=2)),
    "glm4-9b-rep16": ("glm4-9b", dict(num_heads=32, num_kv_heads=2)),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread runs them faster and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32():
    import repro.models.layers as L
    old = L.DEFAULT_DTYPE
    L.DEFAULT_DTYPE = jnp.float32
    yield
    L.DEFAULT_DTYPE = old


def _same_fields(tcfg, jcfg):
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
            (tcfg.name, f.name)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_and_reduced_equal_reference(name):
    tcfg, jcfg = get_arch(name), jax_get_arch(name)
    _same_fields(tcfg, jcfg)
    _same_fields(reduced(tcfg), jax_reduced(jcfg))
    build_model(tcfg, device="cpu")         # StackedLM's guard admits it


def test_registry_holds_the_dense_configs():
    assert sorted(ARCHS) == sorted(["llama3.2-1b"] + NEW)
    assert (get_arch("llama3.2-3b").head_dim,
            get_arch("llama3.2-3b").q_per_kv) == (128, 3)
    assert get_arch("glm4-9b").q_per_kv == 16
    assert not get_arch("glm4-9b").tie_embeddings
    moe = get_arch("qwen2-moe-a2.7b")
    assert (moe.is_moe, moe.use_bias, moe.q_per_kv, moe.head_dim) == \
        (True, True, 1, 128)
    assert not any(c.is_moe or c.use_bias for n, c in ARCHS.items()
                   if n != "qwen2-moe-a2.7b")


def _models(variant):
    return _pair(*VARIANTS[variant])


def _pair(arch, kw):
    """Both packages' reduced ``arch`` (fields ``kw`` replaced) on one set
    of f32 parameters drawn by the JAX package: (japi, jparams, tapi,
    tparams)."""
    from repro.models.api import build_model as jax_build
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), **kw)
    _same_fields(tcfg, jcfg)
    japi = jax_build(jcfg, max_seq=128)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           japi.init(jax.random.PRNGKey(2)))
    if jcfg.use_bias:
        # the reference initialises biases to zero; draw them nonzero so
        # that the comparison sees them
        attn = jparams["blocks"]["attn"]
        for i, b in enumerate(("bq", "bk", "bv")):
            attn[b] = 0.5 * jax.random.normal(jax.random.PRNGKey(10 + i),
                                              attn[b].shape, jnp.float32)
    tapi = build_model(tcfg, device="cpu", dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return japi, jparams, tapi, tparams


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reduced_model_matches_reference(f32, variant):
    japi, jparams, tapi, tparams = models = _models(variant)
    cfg = tapi.cfg
    assert ("head" in tparams) == (not cfg.tie_embeddings)
    if "head" in tparams:
        assert torch.equal(tparams["head"],
                           tensor_from_numpy(jparams["head"]))
    rng = np.random.RandomState(3)
    for P in (11, 5):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :P] = rng.randint(0, cfg.vocab_size, size=P)
        jl, _ = japi.prefill_at_fn(jparams, {"tokens": jnp.asarray(toks),
                                             "prompt_len": jnp.int32(P)})
        tl, _ = tapi.prefill_at_fn(tparams, {"tokens": torch.from_numpy(toks),
                                             "prompt_len": P})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    st = _both(models, _workload(1, 10, shared_ratio=0.5), num_pages=12)
    assert st["swap_outs"] > 0 and st["cow_hits"] > 0


def test_shapes_and_families_equal_reference():
    from repro import configs as JC
    from repro_torch import configs as C
    assert {k: dataclasses.astuple(v) for k, v in C.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JC.SHAPES.items()}
    for name in C.SHAPES:
        assert dataclasses.astuple(C.get_shape(name)) == \
            dataclasses.astuple(JC.get_shape(name))
        assert C.get_shape(name).tokens == JC.get_shape(name).tokens
    with pytest.raises(KeyError):
        C.get_shape("train_8k")
    for fam in ("DENSE", "MOE", "SSM", "HYBRID", "ENCDEC", "VLM", "CNN"):
        assert getattr(C, fam) == getattr(JC, fam)
    assert C.base.FAMILIES == (C.DENSE, C.MOE)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analytic_cost_equals_reference(name):
    from repro import configs as JC
    from repro.utils import analytic_cost as JA
    from repro_torch import configs as C
    from repro_torch.utils import analytic_cost as A
    tcfg, jcfg = get_arch(name), jax_get_arch(name)
    assert tcfg.is_subquadratic == jcfg.is_subquadratic is False
    ran = 0
    for sname, shape in C.SHAPES.items():
        ok = C.shape_applicable(tcfg, shape)
        assert ok == JC.shape_applicable(jcfg, JC.SHAPES[sname])
        if not ok[0]:
            continue
        for kw in ({}, dict(cache_bytes=1), dict(state_bytes=2)):
            got = A.estimate(tcfg, shape, **kw)
            want = JA.estimate(jcfg, JC.SHAPES[sname], **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), \
                (name, sname, kw)
            assert got.useful_ratio == want.useful_ratio
        ran += 1
    assert ran == 3                     # long_500k needs sub-quadratic


def test_analytic_cost_reflects_quant():
    """The reference's test (tests/test_perf_features.py) on the port."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.utils.analytic_cost import estimate
    cfg = get_arch("command-r-35b")
    shape = ShapeConfig("d", 32768, 128, "decode")
    base = estimate(cfg, shape, cache_bytes=2)
    opt = estimate(cfg, shape, cache_bytes=1)
    assert opt.hbm_bytes < 0.62 * base.hbm_bytes
    from repro.configs import ShapeConfig as JShape
    from repro.utils.analytic_cost import estimate as jestimate
    for cb, got in ((2, base), (1, opt)):
        want = jestimate(jax_get_arch("command-r-35b"),
                         JShape("d", 32768, 128, "decode"), cache_bytes=cb)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
