"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``): the CPU path of ``ops`` and the oracle every
CUDA kernel is held against on the card. The ciphers' ``key`` and
``counter`` are ints or one-element integer tensors on the data's device
(``seal.keystream_u32``): a tensor is used in tensor arithmetic, never read
back to the host."""
from __future__ import annotations

import math

import torch

from .seal import int_dtype_of, keystream_u32, to_signed


def _flat_index(shape, device, col0: int = 0,
                row_cols=None) -> torch.Tensor:
    """int64 row-major element index of a [rows, cols] array (the keystream
    takes it modulo 2**32, as JAX's uint32 ``row * cols + col`` wraps); of
    columns [col0, col0 + cols) of rows ``row_cols`` wide when the array
    is such a window: ``row * row_cols + col0 + col``."""
    rows, cols = shape
    row_cols = cols if row_cols is None else row_cols
    return (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
            * row_cols + col0
            + torch.arange(cols, dtype=torch.int64, device=device)[None, :])


# ---------------------------------------------------------------------------
# seal / unseal — int8 quantize + keystream XOR (stage boundaries)
# ---------------------------------------------------------------------------
def _top_byte(shape, key, counter, device) -> torch.Tensor:
    return keystream_u32(key, counter, _flat_index(shape, device)) >> 24


def seal_ref(x: torch.Tensor, key, counter):
    """x [rows, cols] float -> (cipher uint8 [rows, cols], scales f32
    [rows, 1]): per-row absmax int8 quantization, scale = max(absmax, 1e-6)
    / 127, q = clip(round_half_even(x / scale), -127, 127) by true division
    (``torch.round`` rounds half to even, as ``jnp.round`` does), then the
    low byte of q XOR the keystream's top byte at the flat index."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    # tensor / tensor: on a CUDA tensor PyTorch turns division by a Python
    # scalar into a multiply by its reciprocal, which is not the IEEE
    # quotient the reference (and the kernel) compute
    scale = absmax.clamp_min(1e-6) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int64)
    cipher = (q & 0xFF) ^ _top_byte(x.shape, key, counter, x.device)
    return cipher.to(torch.uint8), scale


def unseal_ref(cipher: torch.Tensor, scales: torch.Tensor, key,
               counter, out_dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    """Inverse of ``seal_ref`` up to the quantization: XOR back, sign-extend
    the byte, multiply by the row scale in f32, cast to ``out_dtype``."""
    q = cipher.to(torch.int64) ^ _top_byte(cipher.shape, key, counter,
                                           cipher.device)
    q = torch.where(q >= 128, q - 256, q).float()
    return (q * scales).to(out_dtype)


# ---------------------------------------------------------------------------
# seal_bits / unseal_bits — lossless bitcast + XOR (KV swap tier)
# ---------------------------------------------------------------------------
def _bits_keystream(shape, key, counter, bits: int, device, col0: int = 0,
                    row_cols=None) -> torch.Tensor:
    return to_signed(keystream_u32(key, counter, _flat_index(
        shape, device, col0, row_cols)), bits)


def seal_bits_ref(x: torch.Tensor, key, counter, col0: int = 0,
                  row_cols=None) -> torch.Tensor:
    """x [rows, cols] float -> cipher int16/int32 of the same bit width:
    the float bits XOR the keystream at flat index ``row*cols + col``
    (modulo 2**32), truncated to the width (low 16 bits for bf16). With a
    window (``col0``, ``row_cols``: x is columns [col0, col0 + cols) of
    rows ``row_cols`` wide) the index is ``row*row_cols + col0 + col``, so
    windows side by side give the whole row's cipher."""
    idt = int_dtype_of(x.dtype)
    u = x.view(idt)
    bits = 8 * x.element_size()
    return u ^ _bits_keystream(x.shape, key, counter, bits, x.device, col0,
                               row_cols)


def unseal_bits_ref(cipher: torch.Tensor, key, counter,
                    out_dtype: torch.dtype = torch.bfloat16, col0: int = 0,
                    row_cols=None) -> torch.Tensor:
    """Inverse of ``seal_bits_ref`` (XOR is an involution): bit-exact."""
    idt = int_dtype_of(out_dtype)
    if cipher.dtype != idt:
        raise TypeError(f"cipher dtype {cipher.dtype} does not carry "
                        f"{out_dtype} bits (expected {idt})")
    bits = 8 * cipher.element_size()
    u = cipher ^ _bits_keystream(cipher.shape, key, counter, bits,
                                 cipher.device, col0, row_cols)
    return u.view(out_dtype)


# ---------------------------------------------------------------------------
# paged decode attention — page-gather oracle
# ---------------------------------------------------------------------------
NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens):
    """Single-token attention over a block-table-indexed paged KV cache.

    q: [B, H, D]; k_pages, v_pages: [num_pages, KVH, page_size, D];
    block_tables: [B, max_pages] int32; seq_lens: [B] int32. Gathers each
    row's pages and runs masked softmax attention in f32, as the JAX oracle
    does — including its idle rows: a row with ``seq_len == 0`` masks every
    position with the same -1e30 and comes out as the finite uniform mean
    of its table's pages."""
    B, H, D = q.shape
    KVH, Pg = k_pages.shape[1], k_pages.shape[2]
    rep = H // KVH
    MP = block_tables.shape[1]
    bt = block_tables.long()
    # [B, MP, KVH, Pg, D] -> [B, KVH, MP * Pg, D]
    k = k_pages[bt].permute(0, 2, 1, 3, 4).reshape(B, KVH, MP * Pg, D)
    v = v_pages[bt].permute(0, 2, 1, 3, 4).reshape(B, KVH, MP * Pg, D)
    qf = q.reshape(B, KVH, rep, D).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k.float()) * (1.0 / math.sqrt(D))
    pos = torch.arange(MP * Pg, device=q.device)
    valid = pos[None, :] < seq_lens.long()[:, None]                  # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention (causal, optional sliding window, query offset) — oracle
# ---------------------------------------------------------------------------
def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: [B, H, Sq, D]; k, v: [B, H, Sk, D] (MHA; GQA handled by the
    wrapper). f32 math, masked scores at -1e30, as the JAX oracle. Query i
    sits at absolute position ``q_offset + i``, the keys at 0 .. Sk-1 (the
    JAX oracle is the case ``q_offset = 0``, Sk = Sq)."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """Gradient of prefill attention, in the model's layout: q, o, do
    [B, Sq, H, D]; k, v [B, Sk, KVH, D], query head h reading KV head
    ``h // (H // KVH)``. Recomputes P in f32 under the forward's mask (the
    reference has no backward kernel: JAX differentiates its plain
    ``chunked_attention``), then the usual identities with
    ``delta = rowsum(do * o)``: dV = Pᵀ dO, dS = P (dO Vᵀ - delta),
    dQ = dS K / sqrt(D), dK = dSᵀ Q / sqrt(D). dK and dV sum over each KV
    head's query group. Returns (dq, dk, dv) in q's, k's and v's types."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    qf = q.float().reshape(B, Sq, KVH, rep, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)                       # [B, KVH, rep, Sq, Sk]
    dof = do.float().reshape(B, Sq, KVH, rep, D)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dof)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dof, vf)
    delta = (dof * o.float().reshape(B, Sq, KVH, rep, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf) / math.sqrt(D)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
