"""Kernels of the PyTorch port.

On the CPU: the port's plain versions against the JAX package's — the
keystream and the page cipher bit for bit, paged decode attention within
atol = rtol = 3e-5 (f32, sums in another order) against both the jnp
oracle and the Pallas kernel in interpret mode — and the dispatch rule
(a CPU tensor takes the plain version and launches nothing).

On a card (marker ``cuda``, skipped without one): each CUDA kernel against
its plain version on the same inputs. Run there with
``python -m pytest -q -m cuda tests/test_torch_kernels.py``; the JAX half
skips where JAX is not installed.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.seal import keystream_u32

PAGED_TOL = dict(atol=3e-5, rtol=3e-5)
KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0xDEADBEEF, 7),
        (0xC0FFEE, 0xA5A50001)]
# the reference's kernel sweeps (tests/test_kernels.py)
SEAL_SHAPES = [(64, 128), (256, 512), (100, 48), (8, 2048), (1, 16)]
PAGED_CASES = [(3, 2, 4, 16, 4, 5), (2, 4, 1, 32, 8, 3), (1, 1, 2, 64, 16, 2),
               (4, 2, 2, 128, 8, 4),
               # head_dim 128 at the grouping of llama3.2-3b (rep 3) and of
               # glm4-9b (rep 16 over 2 KV heads)
               (3, 2, 3, 128, 16, 3), (2, 2, 16, 128, 16, 2)]
SHARED_CASES = [(3, 2, 4, 16, 4, 5, 2), (4, 2, 2, 32, 8, 4, 3),
                (2, 1, 2, 64, 16, 3, 1)]
# on the card only: the serving decode shapes, whose pages the kernel
# splits over several blocks per (row, KV head)
CARD_PAGED_CASES = PAGED_CASES + [(8, 8, 4, 64, 16, 10), (8, 8, 4, 64, 16, 34)]
# on the card only: head_dim 128 at serving widths, paged decode (B = 8,
# page 16, a 10-page table) and one-shot prefill (B, S, H, KVH) for
# llama3.2-3b (rep 3) and glm4-9b (rep 16)
CARD_D128 = [dict(KVH=8, rep=3, S=128), dict(KVH=2, rep=16, S=128)]
CARD_SHARED_CASES = SHARED_CASES + [(8, 8, 4, 64, 16, 34, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread runs them faster and
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

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.seal import keystream_u32 as jks
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref,
                                 keystream=jks)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# keystream + page cipher: bit for bit across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key,ctr", KEYS)
def test_keystream_bit_exact_vs_jax(jx, key, ctr):
    idx = np.concatenate([np.arange(4 * 65536, dtype=np.uint64),
                          np.uint64(2**32) - np.arange(1, 1025,
                                                       dtype=np.uint64)])
    want = np.asarray(jx.keystream(jx.jnp.uint32(key), jx.jnp.uint32(ctr),
                                   jx.jnp.asarray(idx.astype(np.uint32))))
    got = keystream_u32(key, ctr, torch.from_numpy(idx.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # indices wrap modulo 2**32 as JAX's uint32 arithmetic does
    wrapped = keystream_u32(key, ctr,
                            torch.from_numpy(idx.astype(np.int64) + 2**32))
    assert torch.equal(wrapped, got)


def _np_dtype_pair(jx, name):
    return {"float32": (jx.jnp.float32, torch.float32),
            "bfloat16": (jx.jnp.bfloat16, torch.bfloat16)}[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SEAL_SHAPES)
def test_seal_bits_ref_same_cipher_bytes_as_jax(jx, shape, dtype):
    jdt, tdt = _np_dtype_pair(jx, dtype)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    key, ctr = 0xDEADBEEF, 7
    jc = np.asarray(jx.ref.seal_bits_ref(jx.jnp.asarray(x).astype(jdt),
                                         jx.jnp.uint32(key),
                                         jx.jnp.uint32(ctr)))
    xt = torch.from_numpy(x).to(tdt)
    tc = ref.seal_bits_ref(xt, key, ctr)
    assert np.array_equal(tc.numpy().view(jc.dtype), jc)
    # a JAX cipher unseals under the port, and back, bit for bit
    jc_signed = torch.from_numpy(jc.view(tc.numpy().dtype).copy())
    back = ref.unseal_bits_ref(jc_signed, key, ctr, tdt)
    assert torch.equal(back.view(tc.dtype), xt.view(tc.dtype))
    jback = jx.ref.unseal_bits_ref(jx.jnp.asarray(tc.numpy().view(jc.dtype)),
                                   jx.jnp.uint32(key), jx.jnp.uint32(ctr),
                                   out_dtype=jdt)
    assert np.array_equal(np.asarray(jback).view(jc.dtype),
                          np.asarray(jx.jnp.asarray(x).astype(jdt)
                                     ).view(jc.dtype))


# ---------------------------------------------------------------------------
# paged decode attention: plain version vs the JAX oracle and Pallas kernel
# ---------------------------------------------------------------------------
def _paged_case(seed, B, KVH, rep, D, Pg, MP):
    rng = np.random.RandomState(seed)
    N = B * MP + 1
    q = rng.randn(B, KVH * rep, D).astype(np.float32)
    kp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    vp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    bt = rng.permutation(N - 1)[: B * MP].reshape(B, MP).astype(np.int32) + 1
    sl = rng.randint(1, MP * Pg + 1, size=B).astype(np.int32)
    return q, kp, vp, bt, sl


def _shared_case(B, KVH, rep, D, Pg, MP, shared):
    rng = np.random.RandomState(11)
    N = shared + B * (MP - shared) + 1
    q = rng.randn(B, KVH * rep, D).astype(np.float32)
    kp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    vp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    bt = np.zeros((B, MP), np.int32)
    nxt = shared + 1
    for b in range(B):
        bt[b, :shared] = np.arange(1, shared + 1)     # aliased prefix
        for pi in range(shared, MP):
            bt[b, pi] = nxt
            nxt += 1
    sl = rng.randint(shared * Pg + 1, MP * Pg + 1, size=B).astype(np.int32)
    return q, kp, vp, bt, sl


def _vs_jax(jx, case):
    q, kp, vp, bt, sl = case
    got = ref.paged_attention_ref(*(torch.from_numpy(a) for a in case))
    assert np.isfinite(got.numpy()).all()
    args = [jx.jnp.asarray(a) for a in case]
    for use_kernel in (False, True):        # jnp oracle, Pallas interpret
        want = jx.ops.paged_attention(*args, use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PAGED_TOL)


@pytest.mark.parametrize("B,KVH,rep,D,Pg,MP", PAGED_CASES)
def test_paged_attention_ref_matches_jax(jx, B, KVH, rep, D, Pg, MP):
    _vs_jax(jx, _paged_case(7, B, KVH, rep, D, Pg, MP))


def test_paged_attention_ref_idle_rows_match_jax(jx):
    """seq_len == 0 rows give the reference's finite uniform mean."""
    q, kp, vp, bt, sl = _paged_case(8, 3, 2, 2, 16, 4, 3)
    sl[1] = 0
    _vs_jax(jx, (q, kp, vp, bt, sl))


@pytest.mark.parametrize("B,KVH,rep,D,Pg,MP,shared", SHARED_CASES)
def test_paged_attention_ref_shared_tables_match_jax(jx, B, KVH, rep, D, Pg,
                                                     MP, shared):
    _vs_jax(jx, _shared_case(B, KVH, rep, D, Pg, MP, shared))


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ops.reset_launch_counts()
    case = [torch.from_numpy(a) for a in _paged_case(3, 2, 2, 2, 16, 4, 3)]
    assert torch.equal(ops.paged_attention(*case),
                       ref.paged_attention_ref(*case))
    x = torch.randn(4, 40)
    c = ops.seal_bits(x, 5, 6)
    assert torch.equal(c, ref.seal_bits_ref(x, 5, 6))
    assert torch.equal(ops.unseal_bits(c, 5, 6, torch.float32), x)
    q, s = ops.seal(x, 5, 6)
    wq, ws = ref.seal_ref(x, 5, 6)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert torch.equal(ops.unseal(q, s, 5, 6, torch.float32),
                       ref.unseal_ref(q, s, 5, 6, torch.float32))
    qa, ka, va = torch.randn(1, 9, 4, 16), torch.randn(1, 12, 2, 16), \
        torch.randn(1, 12, 2, 16)
    want = ref.flash_attention_ref(
        qa.transpose(1, 2), ka.repeat_interleave(2, 2).transpose(1, 2),
        va.repeat_interleave(2, 2).transpose(1, 2), q_offset=3)
    assert torch.equal(ops.flash_attention(qa, ka, va, q_offset=3),
                       want.transpose(1, 2))
    assert ops.LAUNCHES == {"paged_attention": 0, "seal_bits": 0,
                            "unseal_bits": 0, "seal": 0, "unseal": 0,
                            "flash_attention": 0}


def test_cipher_rejects_wrong_types():
    with pytest.raises(TypeError):
        ops.seal_bits(torch.zeros(2, 4, dtype=torch.float16), 1, 2)
    with pytest.raises(TypeError):
        ops.unseal_bits(torch.zeros(2, 4, dtype=torch.int32), 1, 2,
                        torch.bfloat16)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KVH,rep,D,Pg,MP", CARD_PAGED_CASES)
def test_paged_attention_kernel_matches_plain(cuda, dtype, B, KVH, rep, D,
                                              Pg, MP):
    """f32 within 3e-5; bf16 within atol 1e-3 + rtol 1e-2: both sides
    accumulate in f32 and round once to bf16, so they may land one bf16
    step (2**-8..2**-7 relative) apart."""
    tdt = getattr(torch, dtype)
    tol = PAGED_TOL if dtype == "float32" else dict(atol=1e-3, rtol=1e-2)
    q, kp, vp, bt, sl = (torch.from_numpy(a).to(cuda)
                         for a in _paged_case(7, B, KVH, rep, D, Pg, MP))
    q, kp, vp = q.to(tdt), kp.to(tdt), vp.to(tdt)
    before = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == before + 1
    want = ref.paged_attention_ref(q, kp, vp, bt, sl)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,KVH,rep,D,Pg,MP,shared", CARD_SHARED_CASES)
def test_paged_attention_kernel_shared_tables_and_idle_rows(
        cuda, B, KVH, rep, D, Pg, MP, shared):
    q, kp, vp, bt, sl = (torch.from_numpy(a).to(cuda) for a in
                         _shared_case(B, KVH, rep, D, Pg, MP, shared))
    sl[0] = 0                                   # an idle slot
    got = ops.paged_attention(q, kp, vp, bt, sl)
    want = ref.paged_attention_ref(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[0].any(), "the kernel writes zeros for idle rows"
    torch.testing.assert_close(got[1:], want[1:], **PAGED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_splits_past_the_row_length(cuda, dtype):
    """Rows of 0, 1, 16, 17 and MP * Pg tokens at the decode shape: splits
    that start past a row's length write the empty marker, the merge skips
    them, idle rows are zero, and a second call gives the same bits."""
    tdt = getattr(torch, dtype)
    tol = PAGED_TOL if dtype == "float32" else dict(atol=1e-3, rtol=1e-2)
    B, KVH, rep, D, Pg, MP = 8, 8, 4, 64, 16, 34
    q, kp, vp, bt, _ = _paged_case(12, B, KVH, rep, D, Pg, MP)
    sl = np.array([0, 1, 16, 17, MP * Pg, 200, MP * Pg - 1, 33], np.int32)
    q, kp, vp, bt, sl = (torch.from_numpy(a).to(cuda)
                         for a in (q, kp, vp, bt, sl))
    q, kp, vp = q.to(tdt), kp.to(tdt), vp.to(tdt)
    assert ops._page_splits(B, KVH, MP, 132) > 1
    got = ops.paged_attention(q, kp, vp, bt, sl)
    again = ops.paged_attention(q, kp, vp, bt, sl)
    want = ref.paged_attention_ref(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not got[0].float().any(), "the kernel writes zeros for idle rows"
    torch.testing.assert_close(got[1:].float(), want[1:].float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_D128, ids=["rep3", "rep16"])
def test_attention_kernels_at_head_dim_128(cuda, dtype, shape):
    """Both attention kernels at head_dim 128 and the full configs' GQA
    groupings, each against its plain version: paged decode over 8 rows of
    a 10-page table, and causal one-shot prefill (flash's two 64-column
    blocks of D). Tolerances as above; a second call repeats the bits."""
    tdt = getattr(torch, dtype)
    tol = PAGED_TOL if dtype == "float32" else dict(atol=1e-3, rtol=1e-2)
    KVH, rep, S = shape["KVH"], shape["rep"], shape["S"]
    q, kp, vp, bt, sl = (torch.from_numpy(a).to(cuda) for a in
                         _paged_case(13, 8, KVH, rep, 128, 16, 10))
    q, kp, vp = q.to(tdt), kp.to(tdt), vp.to(tdt)
    got = ops.paged_attention(q, kp, vp, bt, sl)
    again = ops.paged_attention(q, kp, vp, bt, sl)
    want = ref.paged_attention_ref(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    g = torch.Generator(device=cuda).manual_seed(3)
    qf = torch.randn(1, S, KVH * rep, 128, generator=g, device=cuda).to(tdt)
    kf, vf = (torch.randn(1, S, KVH, 128, generator=g, device=cuda).to(tdt)
              for _ in range(2))
    got = ops.flash_attention(qf, kf, vf)
    again = ops.flash_attention(qf, kf, vf)
    want = ref.flash_attention_ref(
        qf.transpose(1, 2), kf.repeat_interleave(rep, 2).transpose(1, 2),
        vf.repeat_interleave(rep, 2).transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **tol)


# every tail length of a 16-byte vector, and the last vector in the last
# block, in the middle of a block and one past a full grid of the swap
# path's plan (640 blocks of 256 threads in bf16)
CIPHER_EDGE_SHAPES = ([(1, 8 * 37 + r) for r in range(1, 8)]
                      + [(1, 8 * (640 * 256 + k) + 3) for k in (-1, 1)]
                      + [(1, 8 * (639 * 256 + 100))])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SEAL_SHAPES + [(3, 131072), (5, 7)]
                         + CIPHER_EDGE_SHAPES)
def test_page_cipher_kernel_bit_exact(cuda, dtype, shape, offset):
    """Every tail length of a 16-byte vector (8 bf16 or 4 f32 lanes), the
    grid's edge, and (offset 1) a contiguous
    tensor that starts one element past a 16-byte boundary, which takes
    the scalar path."""
    tdt = getattr(torch, dtype)
    n = shape[0] * shape[1]
    base = torch.randn(n + offset, device=cuda).to(tdt)
    x = base[offset:].view(shape)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    for key, ctr in KEYS:
        c = ops.seal_bits(x, key, ctr)
        assert torch.equal(c, ref.seal_bits_ref(x, key, ctr))
        back = ops.unseal_bits(c, key, ctr, tdt)
        assert torch.equal(back.view(c.dtype), x.view(c.dtype))


@pytest.mark.cuda
def test_page_cipher_kernel_unaligned_view(cuda):
    """A view that does not start on a 16-byte boundary takes the scalar
    path and still gives the plain version's bits."""
    base = torch.randn(1, 4 * 131 + 1, device=cuda)
    x = base[:, 1:].reshape(4, 131)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    assert torch.equal(ops.seal_bits(x, 9, 10), ref.seal_bits_ref(x, 9, 10))
