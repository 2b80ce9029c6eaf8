"""Model parity of the PyTorch port against the JAX package (CPU, f32).

The same parameters (drawn by the JAX package, carried across with
``repro_torch.weights.params_from_jax``) and the same prompts go through
``repro`` and ``repro_torch``: the prefill logits and KV, and eight
successive paged decode steps, must agree within atol = rtol = 1e-4 (f32
sums are taken in another order by XLA and by PyTorch) and pick the same
greedy tokens. Runs on reduced llama3.2-1b (rep 1) and a GQA variant with
two KV heads (rep 2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro_torch.configs import get_arch, reduced
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax, tensor_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
PG, MP, N = 4, 6, 16


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


def _cfgs(kv):
    jcfg = jax_reduced(jax_get_arch("llama3.2-1b"))
    tcfg = reduced(get_arch("llama3.2-1b"))
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=kv)
    return jcfg, tcfg


def _models(kv):
    from repro.models.api import build_model as jax_build
    jcfg, tcfg = _cfgs(kv)
    japi = jax_build(jcfg, max_seq=128)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           japi.init(jax.random.PRNGKey(0)))
    tapi = build_model(tcfg, device="cpu", dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return japi, jparams, tapi, tparams


def test_config_copy_matches_reference():
    for kv in (None, 2):
        jcfg, tcfg = _cfgs(kv)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert get_arch("llama3.2-1b") == get_arch("llama3.2-1b")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_params_from_jax_keeps_tree_layout_and_bits():
    from repro.models.api import build_model as jax_build
    jcfg, tcfg = _cfgs(None)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(1))     # bf16 leaves
    t = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tapi = build_model(tcfg, device="cpu")
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tt = jax.tree.map(lambda a: tuple(a.shape), t)
    assert tt == ref_shapes
    spec_shapes = jax.tree.map(lambda s: s.shape, tapi.param_specs(),
                               is_leaf=lambda s: hasattr(s, "init"))
    assert spec_shapes == ref_shapes
    wq = t["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert np.array_equal(
        wq.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jparams["blocks"]["attn"]["wq"]).view(np.uint16))
    # an explicit dtype casts floating leaves
    t32 = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                          torch.float32)
    assert t32["embed"].dtype == torch.float32


def test_init_uses_generator_and_reference_scales():
    _, tcfg = _cfgs(None)
    api = build_model(tcfg, device="cpu", dtype=torch.float32)
    a = api.init(torch.Generator().manual_seed(3))
    b = api.init(torch.Generator().manual_seed(3))
    c = api.init(torch.Generator().manual_seed(4))
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["ln_f"], torch.ones_like(a["ln_f"]))
    # embedding std 0.02; stacked weights std 1/sqrt(leading dim = layers)
    assert abs(a["embed"].std().item() - 0.02) < 2e-3
    wi = a["blocks"]["mlp"]["wi"]
    assert abs(wi.std().item() - 1 / np.sqrt(tcfg.num_layers)) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_reference(dtype):
    import repro.models.layers as JL
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 40], [7, 8, 9, 10, 11]], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    js, ts = jnp.asarray(scale).astype(jdt), torch.from_numpy(scale).to(tdt)
    got = TL.rmsnorm(tx, ts).float().numpy()
    want = np.asarray(JL.rmsnorm(jx, js).astype(jnp.float32))
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got, want, **tol)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 500_000.0).float().numpy()
    want = np.asarray(JL.apply_rope(jx, jnp.asarray(pos), 500_000.0)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, **tol)


def test_causal_attention_matches_chunked_attention():
    import repro.models.layers as JL
    rng = np.random.RandomState(2)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    v = rng.randn(2, 12, 2, 16).astype(np.float32)
    want = np.asarray(JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=True))
    got = TL.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_write_drops_null_and_out_of_table_rows(f32):
    """Rows on the null page and rows whose position runs past the table
    are dropped by both packages; page 0 stays zero."""
    import repro.models.layers as JL
    rng = np.random.RandomState(3)
    k_pool = rng.randn(N, 2, PG, 16).astype(np.float32)
    k_pool[0] = 0
    v_pool = rng.randn(N, 2, PG, 16).astype(np.float32)
    v_pool[0] = 0
    bt = np.array([[1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 0],
                   [7, 8, 9, 10, 11, 12], [13, 0, 0, 0, 0, 0]], np.int32)
    sl = np.array([5, 0, MP * PG, 6], np.int32)   # live, idle, past, null
    kn = rng.randn(4, 2, 16).astype(np.float32)
    vn = rng.randn(4, 2, 16).astype(np.float32)
    jk, jv = JL.paged_write(jnp.asarray(k_pool), jnp.asarray(v_pool),
                            jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(bt), jnp.asarray(sl))
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    TL.paged_write(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                   torch.from_numpy(bt), torch.from_numpy(sl))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert not tk[0].any() and not tv[0].any()
    assert not np.array_equal(tk.numpy(), k_pool)      # row 0 did write


def _paged_cache_from_prefill(rows, dtype=np.float32):
    """Build identical numpy paged caches from per-row prefill KV:
    rows = [(kk [L, KVH, S, D], vv, P, pages)]."""
    Lyr, KVH, _, D = rows[0][0].shape
    kp = np.zeros((Lyr, N, KVH, PG, D), dtype)
    vp = np.zeros_like(kp)
    B = len(rows) + 1                                  # + one idle row
    bt = np.zeros((B, MP), np.int32)
    sl = np.zeros(B, np.int32)
    for b, (kk, vv, P, pages) in enumerate(rows):
        bt[b, :len(pages)] = pages
        sl[b] = P
        for t in range(P):
            kp[:, pages[t // PG], :, t % PG] = kk[:, :, t]
            vp[:, pages[t // PG], :, t % PG] = vv[:, :, t]
    return kp, vp, bt, sl


@pytest.mark.parametrize("kv", [None, 2], ids=["rep1", "gqa_rep2"])
def test_prefill_and_paged_decode_match_reference(f32, kv):
    japi, jparams, tapi, tparams = _models(kv)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, size=11), rng.randint(0, 512, size=6)]
    rows = []
    for i, pr in enumerate(prompts):
        P = len(pr)
        toks = np.zeros((1, 16), np.int32)
        toks[0, :P] = pr
        jl, jc = japi.prefill_at_fn(jparams, {"tokens": jnp.asarray(toks),
                                              "prompt_len": jnp.int32(P)})
        tl, tc = tapi.prefill_at_fn(tparams, {"tokens": torch.from_numpy(toks),
                                              "prompt_len": P})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jkk, jvv = (np.asarray(a)[:, 0] for a in jc["blocks"])
        tkk, tvv = (a[:, 0].numpy() for a in tc["blocks"])
        np.testing.assert_allclose(tkk[:, :, :P], jkk[:, :, :P], **TOL)
        np.testing.assert_allclose(tvv[:, :, :P], jvv[:, :, :P], **TOL)
        assert int(np.argmax(np.asarray(jl))) == int(tl.argmax())
        pages = [1 + 5 * i + j for j in range(-(-P // PG))]
        rows.append((jkk, jvv, P, pages))

    kp, vp, bt, sl = _paged_cache_from_prefill(rows)
    jcache = {"blocks": (jnp.asarray(kp), jnp.asarray(vp)),
              "block_tables": jnp.asarray(bt), "seq_lens": jnp.asarray(sl)}
    tcache = {"blocks": (torch.from_numpy(kp.copy()),
                         torch.from_numpy(vp.copy())),
              "block_tables": torch.from_numpy(bt.copy()),
              "seq_lens": torch.from_numpy(sl.copy())}
    # grow the tables two pages ahead so eight steps never run out
    for b, (_, _, P, pages) in enumerate(rows):
        bt[b, len(pages):len(pages) + 2] = [pages[-1] + 1, pages[-1] + 2]
    jcache["block_tables"] = jnp.asarray(bt)
    tcache["block_tables"] = torch.from_numpy(bt.copy())
    toks = np.zeros((3, 1), np.int32)
    for _ in range(8):
        jl, jcache = japi.decode_paged_fn(jparams, jcache,
                                          {"tokens": jnp.asarray(toks)})
        tl, tcache = tapi.decode_paged_fn(tparams, tcache,
                                          {"tokens": torch.from_numpy(toks)})
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        assert np.isfinite(tl.numpy()).all()
        assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        assert np.array_equal(tcache["seq_lens"].numpy(),
                              np.asarray(jcache["seq_lens"]))
        toks = jl.argmax(-1).astype(np.int32)[:, None]
    np.testing.assert_allclose(tcache["blocks"][0].numpy(),
                               np.asarray(jcache["blocks"][0]), **TOL)
    assert not tcache["blocks"][0][:, 0].any()         # null page untouched


def test_tensor_from_numpy_roundtrips_bf16_bits():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = tensor_from_numpy(x)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == np.asarray(x, np.float32).tolist()
