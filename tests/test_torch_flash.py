"""Prefill attention of the PyTorch port (the flash-attention kernel's
function) against the JAX package.

On the CPU: the port's plain version ``ref.flash_attention_ref`` against
the JAX oracle ``ref.flash_attention_ref`` and the Pallas kernel
``flash_attention_pallas`` in interpret mode over the reference's grid
(window and non-causal cases included); the GQA wrapper
``ops.flash_attention`` against the JAX wrapper's plain path, with ragged
lengths; and the query offset against the JAX package's
``layers.chunked_attention(q_offset=...)``. All in f32 within
atol = rtol = 3e-5 (sums in another order), the reference's own tolerance.

On a card (marker ``cuda``, skipped without one): the CUDA kernel against
the plain version at the shapes ``chip_smoke.py`` checks — the reference
grid, ragged lengths, head_dim 128, GQA rep 4, the prefill path's
one-shot, packed and chunk shapes and short chunks late in a long
prompt — and repeated calls bit for bit. Run there with
``python -m pytest -q -m cuda tests/test_torch_flash.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL

TOL = dict(atol=3e-5, rtol=3e-5)
# the reference's sweep (tests/test_kernels.py): B, H, S, D, window, causal
GRID = [(2, 4, 256, 64, 0, True), (1, 2, 128, 32, 64, True),
        (2, 2, 64, 16, 0, True), (1, 1, 512, 64, 0, True),
        (1, 2, 128, 32, 0, False)]
# wrapper cases: B, Sq, H, KVH, D (GQA and ragged lengths)
WRAPPER = [(2, 64, 8, 2, 16), (1, 77, 4, 2, 32), (2, 1, 4, 1, 16),
           (1, 100, 4, 4, 128)]
# offset cases: Sq, Sk, q_offset, H, KVH, D
OFFSET = [(8, 45, 37, 4, 2, 16), (16, 64, 48, 2, 2, 32), (5, 5, 0, 4, 1, 16),
          (3, 40, 37, 8, 2, 64)]
# the kernel on the card: B, Sq, Sk, H, KVH, D, causal, window, q_offset
CARD = ([(B, S, S, H, H, D, int(c), w, 0) for B, H, S, D, w, c in GRID]
        + [(2, 77, 77, 4, 2, 64, 1, 0, 0), (1, 1, 1, 4, 1, 64, 1, 0, 0),
           (1, 100, 100, 8, 2, 128, 1, 0, 0), (2, 96, 96, 16, 4, 64, 1, 0, 0),
           (1, 512, 512, 32, 8, 64, 1, 0, 0), (4, 128, 128, 32, 8, 64, 1, 0, 0),
           (1, 128, 512, 32, 8, 64, 1, 0, 384),
           (1, 8, 45, 4, 2, 64, 1, 0, 37), (1, 5, 300, 4, 2, 64, 0, 0, 0)]
        # few query tiles: a short chunk late in a prompt; windowed GQA,
        # D 64 and 128
        + [(1, 64, 512, 32, 8, 64, 1, 0, 448),
           (1, 48, 400, 8, 2, 64, 1, 100, 352),
           (1, 40, 300, 4, 2, 128, 1, 64, 260)])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fast and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package as the oracle (absent on hosts without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as jlayers
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref,
                                 layers=jlayers,
                                 pallas=flash_attention_pallas)


@pytest.fixture(scope="module")
def grid_runs(jx):
    """Inputs of every grid case and the JAX oracle's and the Pallas
    kernel's outputs, computed once for the module."""
    runs = {}
    for case in GRID:
        B, H, S, D, win, causal = case
        rng = np.random.RandomState(4)
        q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
        want = np.asarray(jx.ref.flash_attention_ref(
            *(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal,
            window=win))
        pallas = np.asarray(jx.pallas(
            *(jx.jnp.asarray(a.reshape(B * H, S, D)) for a in (q, k, v)),
            causal=causal, window=win)).reshape(B, H, S, D)
        runs[case] = (q, k, v, want, pallas)
    return runs


def _case(seed, B, Sq, Sk, H, KVH, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, KVH, D).astype(np.float32),
            rng.randn(B, Sk, KVH, D).astype(np.float32))


@pytest.mark.parametrize("case", GRID, ids=[str(c) for c in GRID])
def test_flash_ref_matches_jax_oracle_and_pallas_kernel(grid_runs, case):
    B, H, S, D, win, causal = case
    q, k, v, want, pallas = grid_runs[case]
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=win).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("B,Sq,H,KVH,D", WRAPPER)
def test_flash_wrapper_matches_jax_wrapper(jx, B, Sq, H, KVH, D):
    """[B, S, H, D] queries over [B, S, KVH, D] keys: query head h reads KV
    head h // (H // KVH), as the reference's jnp.repeat."""
    q, k, v = _case(5, B, Sq, Sq, H, KVH, D)
    want = np.asarray(jx.ops.flash_attention(
        *(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
        use_kernel=False))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    assert got.shape == (B, Sq, H, D) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("Sq,Sk,q_offset,H,KVH,D", OFFSET)
def test_flash_offset_matches_chunked_attention(jx, Sq, Sk, q_offset, H, KVH,
                                                D):
    """Query i at absolute position q_offset + i over keys 0 .. Sk-1: the
    JAX package's chunked_attention(q_offset=...), causal, and
    layers.chunked_attention of the port through the same wrapper."""
    q, k, v = _case(6, 1, Sq, Sk, H, KVH, D)
    want = np.asarray(jx.layers.chunked_attention(
        *(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
        q_offset=q_offset))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(TL.chunked_attention(tq, tk, tv, causal=True,
                                            q_offset=q_offset), got)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _case(7, 1, 8, 12, 4, 2, 16))
    with pytest.raises(ValueError, match="Sk"):
        ops.flash_attention(q, k, v, causal=True, q_offset=5)
    with pytest.raises(ValueError, match="inconsistent"):
        ops.flash_attention(q, k, v[:, :, :1], causal=True)
    with pytest.raises(ValueError, match="inconsistent"):
        ops.flash_attention(q[:, :, :3], k, v, causal=True)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, causal=False, q_offset=-1)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD, ids=[str(c) for c in CARD])
def test_flash_kernel_matches_plain(cuda, dtype, case):
    """f32 within 3e-5; bf16 within atol 1e-3 + rtol 1e-2: both sides
    accumulate in f32 and round once to bf16, so they may land one bf16
    step (2**-8..2**-7 relative) apart."""
    B, Sq, Sk, H, KVH, D, causal, window, off = case
    tdt = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=1e-3, rtol=1e-2)
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _case(8, B, Sq, Sk, H, KVH, D))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=bool(causal), window=window,
                              q_offset=off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    rep = H // KVH
    want = ref.flash_attention_ref(
        q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
        v.repeat_interleave(rep, 2).transpose(1, 2), causal=bool(causal),
        window=window, q_offset=off).transpose(1, 2)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 128, 512, 32, 8, 64, 1, 0, 384),
                                  (1, 48, 400, 8, 2, 64, 1, 100, 352)])
def test_flash_kernel_repeats_bit_for_bit(cuda, case):
    """Each block sums its keys in one fixed order, so two calls on the
    same inputs give the same bits."""
    B, Sq, Sk, H, KVH, D, causal, window, off = case
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _case(9, B, Sq, Sk, H, KVH, D))
    runs = [ops.flash_attention(q, k, v, causal=bool(causal), window=window,
                                q_offset=off) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
