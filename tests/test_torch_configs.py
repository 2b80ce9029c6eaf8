"""The port's configs against the JAX package's (CPU, f32).

llama3.2-3b, glm4-9b and command-r-35b are the reference's dense configs
that ``StackedLM`` serves (RoPE, full attention, no bias), qwen2-moe-a2.7b
its MoE config (attention biases, 60 experts top-4 plus 4 shared; reduced:
8 experts top-2 plus 1 shared); qwen2-vl-7b (VLM), moonshot-v1-16b-a3b
(MoE with a dense stem), hymba-1.5b (hybrid), xlstm-125m (SSM) and
whisper-small (encoder-decoder) are held in their own files
(``test_torch_vlm.py``, ``test_torch_segments.py``,
``test_torch_hymba.py``, ``test_torch_xlstm.py``,
``test_torch_whisper.py``) and here by their fields, parameter counts,
analytic costs and the reference's per-family smoke. The registry is the
reference's, and every config's fields, and those of its ``reduced``
form, must equal the reference's. On the same parameters
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
reference's values exactly for every registered config and shape
(hymba-1.5b and xlstm-125m, sub-quadratic, also at ``long_500k``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ARCHS, get_arch, list_archs, reduced
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax, tensor_from_numpy
from test_torch_engine import _both
from test_torch_serving import _workload

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ["llama3.2-3b", "glm4-9b", "command-r-35b", "qwen2-moe-a2.7b"]
FAMILY_NEW = ["qwen2-vl-7b", "moonshot-v1-16b-a3b", "hymba-1.5b"]
LAST_NEW = ["xlstm-125m", "whisper-small"]
SUBQUADRATIC = ("hymba-1.5b", "xlstm-125m")
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
    """The dense and MoE configs, qwen2-vl-7b (VLM), moonshot-v1-16b-a3b
    (MoE with a dense stem), hymba-1.5b (hybrid), xlstm-125m (SSM) and
    whisper-small (encoder-decoder): the port's registry is the
    reference's."""
    from repro.configs import list_archs as jax_list_archs
    assert sorted(ARCHS) == sorted(["llama3.2-1b"] + NEW + FAMILY_NEW
                                   + LAST_NEW)
    assert list_archs() == jax_list_archs()
    assert (get_arch("llama3.2-3b").head_dim,
            get_arch("llama3.2-3b").q_per_kv) == (128, 3)
    assert get_arch("glm4-9b").q_per_kv == 16
    assert not get_arch("glm4-9b").tie_embeddings
    moe = get_arch("qwen2-moe-a2.7b")
    assert (moe.is_moe, moe.use_bias, moe.q_per_kv, moe.head_dim) == \
        (True, True, 1, 128)
    assert {n for n, c in ARCHS.items() if c.is_moe or c.use_bias} == \
        {"qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "qwen2-vl-7b",
         "whisper-small"}


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
    assert C.base.FAMILIES == JC.base.FAMILIES


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analytic_cost_equals_reference(name):
    from repro import configs as JC
    from repro.utils import analytic_cost as JA
    from repro_torch import configs as C
    from repro_torch.utils import analytic_cost as A
    tcfg, jcfg = get_arch(name), jax_get_arch(name)
    assert tcfg.is_subquadratic == jcfg.is_subquadratic == \
        (name in SUBQUADRATIC)
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
    # long_500k needs sub-quadratic decode: Hymba (SSM state + window)
    # and xLSTM (recurrent state)
    assert ran == (4 if tcfg.is_subquadratic else 3)


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


def test_list_archs_and_has_decoder_equal_reference():
    from repro import configs as JC
    from repro_torch import configs as C
    assert C.list_archs() == sorted(C.ARCHS) == JC.list_archs()
    for name in C.list_archs():
        assert get_arch(name).has_decoder == jax_get_arch(name).has_decoder \
            is True


@pytest.mark.parametrize("name", FAMILY_NEW + LAST_NEW)
def test_models_smoke_on_port(name):
    """``tests/test_models_smoke.py`` on the port for the VLM, moonshot,
    Hymba, xLSTM and Whisper: a train loss of ~ln(vocab) at init, finite
    prefill and decode logits from ``make_inputs`` (Whisper's with
    ``frames``), ``len`` advanced by one (the decode writes into the
    prefill's full cache at its last slot, as the reference's smoke
    does)."""
    from repro_torch.configs import ShapeConfig
    api = build_model(reduced(get_arch(name)), device="cpu", max_seq=32)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen)
    loss = api.loss_fn(params, api.make_inputs(ShapeConfig("t", 32, 2,
                                                           "train"), gen))
    assert loss.shape == () and 1.0 < float(loss) < 15.0
    logits, cache = api.prefill_fn(params, api.make_inputs(
        ShapeConfig("p", 32, 2, "prefill"), gen))
    assert tuple(logits.shape) == (2, api.cfg.vocab_size)
    assert torch.isfinite(logits).all()
    n = int(cache["len"])
    logits2, cache = api.decode_fn(params, cache, api.make_inputs(
        ShapeConfig("d", 32, 2, "decode"), gen))
    assert tuple(logits2.shape) == (2, api.cfg.vocab_size)
    assert torch.isfinite(logits2).all()
    assert int(cache["len"]) == n + 1
