"""Model substrate of the port (dense subset of ``repro/models/layers.py``):
norms, rotary embeddings, projections, SwiGLU, causal prefill attention
and the paged decode path.

Layouts are the reference's: activations [B, S, ...], ``wq [d, H, hd]``,
``wo [H, hd, d]``, page pools ``[N, KVH, page_size, D]``. The paged write
updates the pools in place (the reference returns new arrays): a pool is
the engine's largest tensor, and copying it every layer of every step would
cost more than the step itself.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KO

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """f32 statistics; cast back to x's type BEFORE the scale multiply, as
    the reference rounds."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=16)
def _device_freqs(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    # copied to the device once: a host-to-device copy from pageable
    # memory in every layer would stall the host on the queued GPU work
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. Angles in
    f32 from the numpy frequencies, as the reference computes them."""
    d = x.shape[-1]
    freqs = _device_freqs(d, theta, x.device)                       # [D/2]
    angles = positions[..., :, None].float() * freqs        # [..., S, D/2]
    angles = angles[..., :, None, :]                        # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Projections / MLP
# ---------------------------------------------------------------------------
def swiglu(x, wi, wg, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def attn_qkv(p, x, positions, cfg):
    """Project to q, k, v and apply RoPE. x: [B, S, d] ->
    q [B, S, H, hd], k and v [B, S, KVH, hd]."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, ctx):
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def causal_attention(q, k, v):
    """Causal self-attention over a whole prompt in f32 — what the
    reference's ``chunked_attention(causal=True)`` computes for prompts up
    to its 2048-token chunk (one block: running max, exp, sum, then P.V
    divided by the sum). q: [B, S, H, D]; k, v: [B, S, KVH, D] (GQA by
    grouping query heads). Returns [B, S, H, D] in q's type."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    qf = q.reshape(B, S, KVH, rep, D).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) * (1.0 / math.sqrt(D))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bkgd->bgrqd", p, v.float())
    out = acc / l.clamp_min(1e-30)                          # [B,KVH,rep,S,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """Single-token attention over a paged KV cache. q: [B, 1, H, D];
    seq_lens counts the valid tokens per row *including* the one just
    written. Goes through ``ops.paged_attention``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    B, _, H, D = q.shape
    out = KO.paged_attention(q.reshape(B, H, D), k_pages, v_pages,
                             block_tables, seq_lens)
    return out.reshape(B, 1, H, D)


def paged_write(k_pages, v_pages, k_new, v_new, block_tables, seq_lens):
    """Write one new token per row into the page pools, in place.

    k_new, v_new: [B, KVH, D] — the token at position ``seq_lens[b]``, in
    page ``block_tables[b, seq_lens[b] // Pg]`` at offset
    ``seq_lens[b] % Pg``. The reference drops two kinds of write: rows
    whose page is the null page 0 (idle slots), and rows whose page index
    runs past the table (its ``take_along_axis`` fills with INT_MIN, which
    the ``mode="drop"`` scatter discards). Here every dropped row is aimed
    at the null page with a zero value instead, so the scatter needs no
    data-dependent row count (no device sync) and page 0 stays all-zero for
    the pool's whole life. Rows that do write never share a target: the
    engine forks any shared page before it can be named here."""
    _, _, Pg, _ = k_pages.shape
    MP = block_tables.shape[1]
    idx = (seq_lens // Pg).long()
    in_table = idx < MP
    page = block_tables.gather(1, idx.clamp(max=MP - 1)[:, None])[:, 0].long()
    keep = in_table & (page != 0)
    page = torch.where(keep, page, torch.zeros_like(page))
    off = torch.where(keep, (seq_lens % Pg).long(), torch.zeros_like(page))
    keep3 = keep[:, None, None]
    # advanced indices split by the head slice put the batch dim first
    k_pages[page, :, off] = torch.where(keep3, k_new, torch.zeros_like(k_new))
    v_pages[page, :, off] = torch.where(keep3, v_new, torch.zeros_like(v_new))
