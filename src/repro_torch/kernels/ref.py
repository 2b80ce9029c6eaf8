"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``): the CPU path of ``ops`` and the oracle every
CUDA kernel is held against on the card."""
from __future__ import annotations

import math

import torch

from .seal import int_dtype_of, keystream_u32, to_signed


# ---------------------------------------------------------------------------
# seal_bits / unseal_bits — lossless bitcast + XOR (KV swap tier)
# ---------------------------------------------------------------------------
def _bits_keystream(shape, key: int, counter: int, bits: int,
                    device) -> torch.Tensor:
    rows, cols = shape
    idx = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
           * cols
           + torch.arange(cols, dtype=torch.int64, device=device)[None, :])
    return to_signed(keystream_u32(key, counter, idx), bits)


def seal_bits_ref(x: torch.Tensor, key: int, counter: int) -> torch.Tensor:
    """x [rows, cols] float -> cipher int16/int32 of the same bit width:
    the float bits XOR the keystream at flat index ``row*cols + col``
    (modulo 2**32), truncated to the width (low 16 bits for bf16)."""
    idt = int_dtype_of(x.dtype)
    u = x.view(idt)
    bits = 8 * x.element_size()
    return u ^ _bits_keystream(x.shape, key, counter, bits, x.device)


def unseal_bits_ref(cipher: torch.Tensor, key: int, counter: int,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``seal_bits_ref`` (XOR is an involution): bit-exact."""
    idt = int_dtype_of(out_dtype)
    if cipher.dtype != idt:
        raise TypeError(f"cipher dtype {cipher.dtype} does not carry "
                        f"{out_dtype} bits (expected {idt})")
    bits = 8 * cipher.element_size()
    u = cipher ^ _bits_keystream(cipher.shape, key, counter, bits,
                                 cipher.device)
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
