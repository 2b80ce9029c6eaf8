"""The multi-segment ``StackedLM`` on the port against the JAX package
(CPU, f32): reduced moonshot-v1-16b-a3b, a ``"stem"`` of one dense block
(SwiGLU of ``dense_stem_d_ff`` = 128) ahead of two MoE blocks (8 experts
top-2 plus one shared) under ``"blocks"``.

The same parameters (drawn by the JAX package, carried across with
``params_from_jax``) and the same numpy tokens go through both packages.
Serving paths dispatch without dropping, so ``prefill_fn``,
``prefill_at_fn``, ``decode_fn`` and ``decode_paged_fn`` agree within
atol = rtol = 1e-4 (f32 sums in another order). Train mode drops at
capacity, and f32 noise can flip a dropping decision between the
packages (ROADMAP §3), so ``hidden_states_fn`` is held block by block
from the reference's own inputs, each layer within 1e-4 of its largest
|value|, and ``loss_fn`` within 1e-5. Both packages' ``pipeline_applicable``
is False for it, and both engines refuse it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.transformer import _unbind
from test_torch_models import PG, _paged_cache_from_prefill
from test_torch_vlm import _j, _t, f32, pair  # noqa: F401 (fixture)

ARCH = "moonshot-v1-16b-a3b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moonshot(f32):
    return pair(ARCH)


def test_segments_and_trees_equal_reference(moonshot):
    japi, jparams, tapi, tparams = moonshot
    assert [(s.name, s.n) for s in tapi.model.segments] == \
        [(s.name, s.n) for s in japi.model.segments] == \
        [("stem", 1), ("blocks", 2)]
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == \
        jax.tree.map(lambda a: tuple(a.shape), tparams)
    assert tuple(tparams["stem"]["mlp"]["wi"].shape) == (1, 64, 128)
    assert "moe" in tparams["blocks"] and "mlp" not in tparams["blocks"]
    jspec, _ = japi.init_cache_specs(2, 16)
    tspec = tapi.init_cache_specs(2, 16)
    assert {k: [tuple(s.shape) for s in v] for k, v in jspec.items()
            if k != "len"} == \
        {k: [shp for shp, _ in v] for k, v in tspec.items() if k != "len"}
    cache = tapi.init_paged_cache(3, 9, 4, 5)
    assert tuple(cache["stem"][0].shape) == (1, 9, 4, 4, 16)
    assert tuple(cache["blocks"][0].shape) == (2, 9, 4, 4, 16)


def test_loss_and_hidden_states_equal_reference(moonshot):
    japi, jparams, tapi, tparams = moonshot
    cfg = tapi.cfg
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    np.testing.assert_allclose(float(tapi.loss_fn(tparams, _t(b))),
                               float(japi.loss_fn(jparams, _j(b))),
                               atol=1e-5, rtol=1e-5)
    want = np.asarray(japi.model.hidden_states_fn(jparams,
                                                  {"tokens": _j(b)["tokens"]}))
    got = tapi.model.hidden_states_fn(tparams, {"tokens": _t(b)["tokens"]})
    assert tuple(got.shape) == want.shape == (1 + 3, 2, 24, 64)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    positions = torch.arange(24)[None, :]
    layers = [(seg, p) for seg in tapi.model.segments
              for p in _unbind(tparams[seg.name], seg.n)]
    with torch.no_grad():
        for l, (seg, p) in enumerate(layers):
            x = torch.from_numpy(want[l].copy())
            out = seg.block.train(p, x, positions)
            scale = np.abs(want[l + 1]).max()
            np.testing.assert_allclose(out.numpy(), want[l + 1],
                                       atol=1e-4 * scale, rtol=0)


def test_prefill_and_decode_equal_reference(moonshot):
    """``prefill_fn`` (both segments' caches), four ``decode_fn`` steps
    from the reference's cache, ``prefill_at_fn`` right-padded, and four
    ``decode_paged_fn`` steps over pools built from it; greedy streams of
    the port's two layouts equal."""
    from repro_torch.weights import cache_from_jax
    japi, jparams, tapi, tparams = moonshot
    cfg = tapi.cfg
    rng = np.random.RandomState(2)
    B, S = 2, 13
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("stem", "blocks"):
        for a, w in zip(tc[name], jc[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    jcache = japi.init_cache(B, 24)
    for name in ("stem", "blocks"):
        jcache[name] = tuple(jax.lax.dynamic_update_slice(z, c, (0,) * 5)
                             for z, c in zip(jcache[name], jc[name]))
    jcache["len"] = jc["len"]
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")

    # the paged layout from the port's own right-padded prefill
    pools, rows_pages = {}, []
    for b in range(B):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :S] = toks[b]
        jal, jac = japi.prefill_at_fn(jparams, {"tokens": jnp.asarray(pad),
                                                "prompt_len": jnp.int32(S)})
        tal, tac = tapi.prefill_at_fn(tparams, {"tokens": torch.from_numpy(
            pad), "prompt_len": S})
        np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **TOL)
        np.testing.assert_allclose(tal.numpy(), tl[b:b + 1].numpy(), **TOL)
        pages = [1 + 6 * b + j for j in range(-(-S // PG))]
        rows_pages.append(pages)
        for name in ("stem", "blocks"):
            kk, vv = (a[:, 0].numpy() for a in tac[name])
            pools.setdefault(name, []).append((kk, vv, S, pages))
    cache = {}
    for name, rows in pools.items():
        kp, vp, bt, sl = _paged_cache_from_prefill(rows)
        cache[name] = (torch.from_numpy(kp), torch.from_numpy(vp))
    for b, pages in enumerate(rows_pages):
        bt[b, len(pages)] = pages[-1] + 1
    cache["block_tables"] = torch.from_numpy(bt)
    cache["seq_lens"] = torch.from_numpy(sl)

    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    stream_t, stream_p = [], []
    for _ in range(4):
        jl, jcache = japi.decode_fn(jparams, jcache,
                                    {"tokens": jnp.asarray(nxt)})
        tl, tcache = tapi.decode_fn(tparams, tcache,
                                    {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pl, cache = tapi.decode_paged_fn(tparams, cache, {
            "tokens": torch.from_numpy(np.concatenate([nxt, [[0]]]))})
        np.testing.assert_allclose(pl[:B].numpy(), tl.numpy(), **TOL)
        stream_t.append(tl.argmax(-1).tolist())
        stream_p.append(pl[:B].argmax(-1).tolist())
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    assert stream_t == stream_p
    assert int(tcache["len"]) == S + 4
    assert cache["seq_lens"].tolist() == [S + 4, S + 4, 0]


def test_pipeline_applicable_false_and_engines_refuse(moonshot):
    from repro.runtime.pipeline import pipeline_applicable as jax_applicable
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    from repro_torch.runtime.pipeline import (PipelinedDecoder,
                                              pipeline_applicable)
    from repro_torch.serving import EngineConfig, ServingEngine
    japi, jparams, tapi, tparams = moonshot
    assert not jax_applicable(japi) and not pipeline_applicable(tapi)
    with pytest.raises(AssertionError, match="single homogeneous segment"):
        JEngine(japi, config=JCfg(), params=jparams, backend="local")
    with pytest.raises(ValueError, match=f"{ARCH}-reduced: serving needs a "
                                         f"single homogeneous segment"):
        ServingEngine(tapi, EngineConfig(), tparams, device="cpu")
    with pytest.raises(AssertionError, match="single homogeneous segment"):
        PipelinedDecoder(tapi, num_stages=2, num_microbatches=2)
    with pytest.raises(ValueError, match="single homogeneous segment"):
        tapi.model.decode_blocks(tparams, None, None, None, None)
