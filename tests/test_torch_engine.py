"""Serving-engine parity of the PyTorch port against the JAX package.

The port's ``ServingEngine`` and the reference's (``mesh=None``, local
paged backend) serve the same prompts on the same f32 parameters (reduced
llama3.2-1b, drawn by the JAX package and carried across). Their greedy
token streams must be equal — with a roomy pool, with a pool tight enough
that demand paging swap-preempts, and with shared prompt prefixes that
make copy-on-write pages hit — and so must their paging decisions
(preemptions, swaps, COW hits, forks). The pool's refcount invariants are
audited after every step. A GQA variant (2 KV heads) runs the same way.
The port's own engine properties are in ``tests/test_torch_serving.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import get_arch, reduced
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax
from test_torch_serving import (BASE, _audit, _drive, _torch_engine,
                                _workload)
PAGING_STATS = ("preemptions", "swap_outs", "swap_ins", "cow_hits", "forks",
                "evictions", "completed", "tokens_out", "steps")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread runs them faster and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    import repro.models.layers as L
    from repro.models.api import build_model as jax_build
    old = L.DEFAULT_DTYPE
    L.DEFAULT_DTYPE = jnp.float32
    japi = jax_build(jax_reduced(jax_get_arch("llama3.2-1b")), max_seq=128)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           japi.init(jax.random.PRNGKey(0)))
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                       dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    yield japi, jparams, tapi, tparams
    L.DEFAULT_DTYPE = old


def _jax_engine(japi, jparams, **kw):
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    cfg = JCfg(num_microbatches=2, max_seq=128, telemetry_interval=4,
               seal_boundary=False, **{**BASE, **kw})
    return JEngine(japi, config=cfg, params=jparams, backend="local")


def _both(models, wl, **kw):
    japi, jparams, tapi, tparams = models
    je = _jax_engine(japi, jparams, **kw)
    te = _torch_engine(tapi, tparams, **kw)
    want = _drive(je, wl)
    got = _drive(te, wl, audit=_audit)
    assert got == want
    js, ts = je.stats(), te.stats()
    for k in PAGING_STATS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    return ts


@pytest.mark.parametrize("policy", ["demand", "reserve"])
def test_streams_match_reference_roomy_pool(models, policy):
    st = _both(models, _workload(0, 8), page_policy=policy)
    assert st["preemptions"] == 0 and st["completed"] == 8


def test_streams_match_reference_under_swap_preemption(models):
    st = _both(models, _workload(1, 10, shared_ratio=0.5), num_pages=12)
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0


@pytest.mark.parametrize("kw", [{}, {"decode_cow": False},
                                {"prefix_sharing": False}],
                         ids=["cow", "no_decode_cow", "no_sharing"])
def test_streams_match_reference_with_shared_prefixes(models, kw):
    st = _both(models, _workload(2, 8, shared_ratio=1.0), **kw)
    assert (st["cow_hits"] > 0) == kw.get("prefix_sharing", True)


def test_gqa_streams_match_reference_under_swap():
    """GQA (2 KV heads for 4 query heads) through the whole engine: paged
    writes, grouped decode attention and swaps of the narrower pages."""
    import dataclasses

    import repro.models.layers as L
    from repro.models.api import build_model as jax_build
    old = L.DEFAULT_DTYPE
    L.DEFAULT_DTYPE = jnp.float32
    try:
        jcfg = dataclasses.replace(
            jax_reduced(jax_get_arch("llama3.2-1b")), num_kv_heads=2)
        japi = jax_build(jcfg, max_seq=128)
        jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                               japi.init(jax.random.PRNGKey(1)))
        tcfg = dataclasses.replace(reduced(get_arch("llama3.2-1b")),
                                   num_kv_heads=2)
        tapi = build_model(tcfg, device="cpu", dtype=torch.float32)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        st = _both((japi, jparams, tapi, tparams),
                   _workload(1, 10, shared_ratio=0.5), num_pages=12)
    finally:
        L.DEFAULT_DTYPE = old
    assert st["swap_ins"] > 0 and st["cow_hits"] > 0


def test_serving_exports_equal_reference():
    """``repro_torch.serving`` exports every name the reference's
    ``serving/__init__.py`` does, less its XLA compile monitor (``AotFn``,
    ``CompileMonitor``, ``MONITOR``; the port's ``GraphFn`` captures CUDA
    graphs instead), and ``pipelined_backend_available`` answers as the
    reference's does where JAX has its shard_map APIs: True (the port's
    pipelined backends need nothing optional)."""
    import repro.serving as JS
    import repro_torch.serving as TS
    xla = {"AotFn", "CompileMonitor", "MONITOR"}
    assert set(JS.__all__) - xla <= set(TS.__all__)
    for name in TS.__all__:
        assert hasattr(TS, name), name
    assert TS.pipelined_backend_available() is True
    assert JS.pipelined_backend_available() is True
