"""qwen2-vl-7b's backbone on the port (``VlmLM``: M-RoPE, the stub patch
frontend) against the JAX package (CPU, f32, reduced config: 4 layers,
4 heads over 4 KV heads, head_dim 16, 8 patches).

The same numpy inputs (tokens, patch embeddings, (t, h, w) positions) and
the same parameters (drawn by the JAX package, attention biases drawn
nonzero there, carried across with ``params_from_jax``) go through both
packages. Tolerances: ``apply_mrope`` within atol = rtol = 1e-5 (XLA's
and torch's f32 cos / sin); the loss within 1e-5; logits and caches
within atol = rtol = 1e-4 (f32 sums in another order). M-RoPE at text
positions (p, p, p) equals RoPE at p in both packages, to 1e-6. The
runtime ``PipelinedDecoder`` (text-only ``pos3`` built per stage, as the
reference's ``pipeline.py`` builds it) unsealed equals the port's
unpipelined decode within 1e-5 on both KV layouts; sealed, within 5e-2
of the largest logit (the reference's sealed tolerance, int8 boundaries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.weights import cache_from_jax, params_from_jax
from test_torch_models import MP, N, PG, _paged_cache_from_prefill

ARCH = "qwen2-vl-7b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread runs them faster and keeps
    parallel test workers from oversubscribing the cores."""
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


def pair(arch, seed=0, max_seq=64, nonzero_bias=True, jit_init=False):
    """(japi, jparams, tapi, tparams): reduced ``arch`` in f32, the JAX
    package's parameters (biases and zero-initialized SSM leaves drawn
    nonzero, which the initializer's zeros would hide) carried across.
    ``jit_init`` draws them in one compiled call (a few seconds faster
    than leaf by leaf; the bits may differ by a bf16 ulp)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.models.api import build_model as jax_build
    japi = jax_build(jax_reduced(jax_get_arch(arch)), max_seq=max_seq)
    init = jax.jit(japi.init) if jit_init else japi.init
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           init(jax.random.PRNGKey(seed)))
    if nonzero_bias:
        rng = np.random.RandomState(seed + 100)

        def draw(path, x):
            name = jax.tree_util.keystr(path)
            if any(k in name for k in ("'bq'", "'bk'", "'bv'", "'conv_b'",
                                       "'dt_bias'", "'a_log'")):
                return jnp.asarray(0.1 * rng.randn(*x.shape), jnp.float32)
            return x
        jparams = jax.tree_util.tree_map_with_path(draw, jparams)
    tapi = build_model(reduced(get_arch(arch)), device="cpu",
                       dtype=torch.float32, max_seq=max_seq)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return japi, jparams, tapi, tparams


def vlm_inputs(cfg, B, S, seed):
    """Tokens [B, S], labels, patch embeddings [B, P, d] and pos3 [B, S, 3]:
    the first P positions an image on a grid (t = 0, h, w), then text at
    (q, q, q) counting on from the grid's largest id."""
    rng = np.random.RandomState(seed)
    P = cfg.num_patches
    g = int(np.ceil(np.sqrt(P)))
    i = np.arange(P)
    img = np.stack([np.zeros(P, np.int64), i // g, i % g], -1)
    q = np.arange(S - P) + g
    txt = np.stack([q, q, q], -1)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "patches": rng.randn(B, P, cfg.d_model).astype(np.float32),
            "pos3": np.repeat(np.concatenate([img, txt])[None], B,
                              0).astype(np.int32)}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in b.items()}


def test_mrope_sections_equal_reference():
    for d, want in ((128, [16, 24, 24]), (16, [2, 3, 3]), (64, [8, 12, 12])):
        sec = np.asarray((16, 24, 24), np.int64)
        sec = (sec * (d // 2) // sec.sum()).tolist()
        sec[-1] = d // 2 - sum(sec[:-1])
        assert TL.mrope_sections(d) == sec == want


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_equals_reference(head_dim):
    import repro.models.layers as JL
    rng = np.random.RandomState(head_dim)
    x = rng.randn(2, 7, 3, head_dim).astype(np.float32)
    pos3 = rng.randint(0, 300, (2, 7, 3)).astype(np.int32)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                     1_000_000.0))
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                         1_000_000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_mrope_at_text_positions_equals_rope(head_dim):
    """(p, p, p) covers the frequencies in section order: M-RoPE is RoPE
    at p, in both packages (what the runtime decoder's text-only pos3
    means)."""
    import repro.models.layers as JL
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 2, head_dim).astype(np.float32)
    p = rng.randint(0, 5000, (2, 9)).astype(np.int32)
    p3 = np.repeat(p[..., None], 3, -1)
    t_m = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6)
    t_r = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(p), 1e6)
    np.testing.assert_allclose(t_m.numpy(), t_r.numpy(), atol=1e-6, rtol=0)
    j_m = JL.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6)
    j_r = JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e6)
    np.testing.assert_allclose(np.asarray(j_m), np.asarray(j_r), atol=1e-6,
                               rtol=0)


def test_vlm_tree_and_input_specs_equal_reference(f32):
    from repro.configs import ShapeConfig as JShape
    from repro_torch.configs import ShapeConfig
    japi, jparams, tapi, tparams = pair(ARCH)
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == \
        jax.tree.map(lambda a: tuple(a.shape), tparams)
    assert tuple(tparams["patch_proj"].shape) == (64, 64)
    for kind in ("train", "prefill", "decode"):
        want = japi.input_specs(JShape("s", 32, 2, kind))
        got = tapi.input_specs(ShapeConfig("s", 32, 2, kind))
        assert {k: tuple(s.shape) for k, s in want.items()} == \
            {k: shp for k, (shp, _) in got.items()}
        made = tapi.make_inputs(ShapeConfig("s", 32, 2, kind),
                                torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in made.items()} == \
            {k: shp for k, (shp, _) in got.items()}
        assert int(made["pos3"].max()) < 4
    meta = {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in tapi.input_specs(ShapeConfig("s", 32, 2,
                                                     "prefill")).items()}
    assert meta["patches"].is_meta


def test_vlm_loss_prefill_hidden_equal_reference(f32):
    japi, jparams, tapi, tparams = pair(ARCH)
    b = vlm_inputs(tapi.cfg, 2, 20, seed=3)
    np.testing.assert_allclose(float(tapi.loss_fn(tparams, _t(b))),
                               float(japi.loss_fn(jparams, _j(b))),
                               atol=1e-5, rtol=1e-5)
    pb = {k: v for k, v in b.items() if k != "labels"}
    jl, jc = japi.prefill_fn(jparams, _j(pb))
    tl, tc = tapi.prefill_fn(tparams, _t(pb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, w in zip(tc["blocks"], jc["blocks"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    assert int(tc["len"]) == 20
    # the patches change the result: the frontend is fused
    tl2, _ = tapi.prefill_fn(tparams, {**_t(pb), "patches": torch.zeros(
        2, tapi.cfg.num_patches, tapi.cfg.d_model)})
    assert not torch.allclose(tl, tl2, **TOL)
    jh = np.asarray(japi.model.hidden_states_fn(jparams, _j(pb)))
    th = tapi.model.hidden_states_fn(tparams, _t(pb)).numpy()
    np.testing.assert_allclose(th, jh, atol=1e-4 * np.abs(jh).max(), rtol=0)
    with pytest.raises(ValueError, match="mrope needs 3-component"):
        tapi.prefill_fn(tparams, {"tokens": torch.from_numpy(b["tokens"])})


def _decode_batches(S0, B, steps, vocab, seed):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, vocab, (B, 1)).astype(np.int32),
             "pos3": np.full((B, 1, 3), S0 + i, np.int32)}
            for i in range(steps)]


def test_vlm_decode_and_paged_decode_equal_reference(f32):
    """From one prefill: ``decode_fn`` (timeline) and ``decode_paged_fn``
    (pages) four steps each in both packages, text positions (p, p, p)
    after the prompt's largest position; the port's two layouts give the
    same logits."""
    japi, jparams, tapi, tparams = pair(ARCH)
    B, S = 2, 20
    b = vlm_inputs(tapi.cfg, B, S, seed=4)
    pb = {k: v for k, v in b.items() if k != "labels"}
    _, jc = japi.prefill_fn(jparams, _j(pb))
    jcache = japi.init_cache(B, 32)
    jcache["blocks"] = tuple(
        jax.lax.dynamic_update_slice(z, c, (0,) * 5)
        for z, c in zip(jcache["blocks"], jc["blocks"]))
    jcache["len"] = jc["len"]
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    kk, vv = (np.asarray(a) for a in jc["blocks"])
    rows = [(kk[:, i], vv[:, i], S, [1 + 8 * i + j for j in range(-(-S //
                                                                   PG))])
            for i in range(B)]
    kp, vp, bt, sl = _paged_cache_from_prefill(rows)
    for i, (_, _, P, pages) in enumerate(rows):
        bt[i, len(pages)] = pages[-1] + 1
    paged = {"blocks": (torch.from_numpy(kp), torch.from_numpy(vp)),
             "block_tables": torch.from_numpy(bt),
             "seq_lens": torch.from_numpy(sl)}
    jpaged = {"blocks": (jnp.asarray(kp), jnp.asarray(vp)),
              "block_tables": jnp.asarray(bt), "seq_lens": jnp.asarray(sl)}
    text0 = int(b["pos3"][0, -1, 0]) + 1
    for db in _decode_batches(text0, B, 4, tapi.cfg.vocab_size, seed=5):
        jl, jcache = japi.decode_fn(jparams, jcache, _j(db))
        tl, tcache = tapi.decode_fn(tparams, tcache, _t(db))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        # paged rows: B live rows and one idle row
        pdb = {"tokens": np.concatenate([db["tokens"], [[0]]]),
               "pos3": np.concatenate([db["pos3"], [[[0, 0, 0]]]])}
        jpl, jpaged = japi.decode_paged_fn(jparams, jpaged, _j(pdb))
        tpl, paged = tapi.decode_paged_fn(tparams, paged, _t(pdb))
        np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), **TOL)
        np.testing.assert_allclose(tpl[:B].numpy(), tl.numpy(), **TOL)
    assert int(tcache["len"]) == S + 4
    assert paged["seq_lens"].tolist() == [S + 4, S + 4, 0]


@pytest.mark.parametrize("paged", [False, True], ids=["timeline", "paged"])
@pytest.mark.parametrize("seal", [False, True], ids=["unsealed", "sealed"])
def test_vlm_pipelined_decoder_equals_unpipelined(f32, paged, seal):
    """``runtime.pipeline.PipelinedDecoder`` on the VLM at uneven blocks
    (1, 3) and two microbatches: text-only pos3 at each row's position,
    built inside the stages, against the port's unpipelined decode with
    the same pos3 (the JAX pipeline needs four XLA devices)."""
    from repro_torch.runtime.pipeline import PipelinedDecoder
    _, _, tapi, tparams = pair(ARCH)
    rng = np.random.RandomState(6)
    B, steps = 4, 3
    if paged:
        cache = tapi.init_paged_cache(B, N, PG, MP)
        sl = torch.tensor([5, 2, 0, 7], dtype=torch.int32)   # row 2 idle
        for b in range(B):
            if sl[b]:
                cache["block_tables"][b, :3] = torch.arange(3) + 1 + 3 * b
        cache["seq_lens"].copy_(sl)
        for t in cache["blocks"]:
            t[:, 1:].copy_(torch.from_numpy(rng.randn(*t[:, 1:].shape)
                                            .astype(np.float32)))
    else:
        cache = tapi.init_cache(B, 16, fill_len=6)
        for t in cache["blocks"]:
            t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)))
    ref = {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
               else v.clone()) for k, v in cache.items()}
    dec = PipelinedDecoder(tapi, num_stages=2, num_microbatches=2,
                           seal_boundary=seal, stage_blocks=(1, 3))
    step = dec.build(paged=paged, per_slot_start=False)
    scale = 0.0
    for i in range(steps):
        toks = torch.from_numpy(rng.randint(0, tapi.cfg.vocab_size, (B, 1)))
        if paged:
            pos = ref["seq_lens"].long()
            want, ref = tapi.decode_paged_fn(tparams, ref, {
                "tokens": toks, "pos3": pos.reshape(B, 1, 1).expand(B, 1, 3)})
            got, cache = step(tparams, cache, {"tokens": toks}, 7 + i)
        else:
            pos3 = ref["len"].reshape(1, 1, 1).expand(B, 1, 3)
            want, ref = tapi.decode_fn(tparams, ref, {"tokens": toks,
                                                      "pos3": pos3})
            body = (cache["blocks"], cache["len"])
            got, _ = step(tparams, body, {"tokens": toks}, 7 + i)
        assert torch.isfinite(got).all()
        scale = max(scale, float(want.abs().max()))
        err = float((got - want).abs().max())
        if seal:
            assert err < 5e-2 * scale, (i, err, scale)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                       rtol=1e-5)
    if not seal:
        for a, w in zip(cache["blocks"], ref["blocks"]):
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5)


def test_engine_refuses_vlm_by_name(f32):
    """The port's engine refuses qwen2-vl at construction, by name; the
    reference's engine constructs (paged) and fails at the first admission
    with its ``attn_qkv`` assertion (no pos3 anywhere in its serving)."""
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    from repro_torch.launch import serve
    from repro_torch.runtime.pipeline import pipeline_applicable
    from repro_torch.serving import EngineConfig, ServingEngine
    japi, jparams, tapi, tparams = pair(ARCH)
    assert pipeline_applicable(tapi)
    with pytest.raises(ValueError, match=f"{ARCH}-reduced: serving a VLM"):
        ServingEngine(tapi, EngineConfig(), tparams, device="cpu")
    with pytest.raises(ValueError, match="serving a VLM"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    jeng = JEngine(japi, config=JCfg(num_slots=2, num_microbatches=1,
                                     prompt_capacity=8, max_seq=32),
                   params=jparams, backend="local")
    assert jeng.kv_layout == "paged"
    jeng.submit([1, 2, 3], 2)
    with pytest.raises(AssertionError, match="mrope needs 3-component"):
        jeng.step()
