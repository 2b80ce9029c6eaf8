"""Model substrate of the port (the dense and MoE subset of
``repro/models/layers.py``): parameter specs and their initializer, norms,
rotary embeddings, projections (with the attention biases), SwiGLU,
prefill attention (one-shot and chunked against the page pools), the
paged decode path, the timeline decode attention (``decode_attention``)
and the training loss (``chunked_softmax_xent``).

Layouts are the reference's: activations [B, S, ...], ``wq [d, H, hd]``,
``wo [H, hd, d]``, page pools ``[N, KVH, page_size, D]``. The paged write
and the chunk write update the pools in place (the reference returns new
arrays): a pool is the engine's largest tensor, and copying it every layer
of every step would cost more than the step itself.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as KO


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"    # normal | zeros | ones | embed
    scale: float = 1.0      # fan-in style scale multiplier


def init_one(spec: ParamSpec, generator: torch.Generator, device,
             dtype) -> torch.Tensor:
    """The reference's initializer (``repro.models.layers._init_one``):
    zeros, ones, N(0, 0.02) for the embedding, else N(0, scale /
    sqrt(fan_in)) with fan_in = the spec's leading dim. For stacked block
    weights that leading dim is the layer count, as in the reference, so
    random-weight runs of the two packages sit in the same numeric range.
    Draws in f32 from ``generator`` (on ``device``), then casts."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device, dtype=dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    std = 0.02 if spec.init == "embed" else spec.scale / math.sqrt(fan_in)
    w = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


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


def attn_specs(cfg) -> Dict[str, ParamSpec]:
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, H, hd)),
        "wk": ParamSpec((d, KVH, hd)),
        "wv": ParamSpec((d, KVH, hd)),
        "wo": ParamSpec((H, hd, d)),
    }
    if cfg.use_bias:
        s.update({"bq": ParamSpec((H, hd), "zeros"),
                  "bk": ParamSpec((KVH, hd), "zeros"),
                  "bv": ParamSpec((KVH, hd), "zeros")})
    return s


def attn_qkv(p, x, positions, cfg):
    """Project to q, k, v, add the biases where the block has them, and
    apply RoPE. x: [B, S, d] -> q [B, S, H, hd], k and v [B, S, KVH, hd]."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, ctx):
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset: int = 0):
    """Prefill attention (the reference's ``chunked_attention``, a double
    ``lax.scan`` computing the flash kernel's function). q: [B, Sq, H, D];
    k, v: [B, Skv, KVH, D] (GQA by head groups); query i at absolute
    position ``q_offset + i``. Goes through ``ops.flash_attention``: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    While autograd records a graph through q, k or v (training), the call
    goes through ``ops.FlashAttentionFn``, which adds the backward.
    Returns [B, Sq, H, D] in q's type."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return KO.flash_attention_train(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    return KO.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)


NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, cache_len, *, rolling: bool = False,
                     start=None):
    """Single-token attention against a contiguous timeline KV cache (the
    reference's ``decode_attention``, plain in both packages: f32 scores,
    a ``NEG_INF`` mask, softmax).

    q: [B, 1, H, D]; caches: [B, KVH, S, D] (any float type, or the f32
    dequantized int8 cache). ``cache_len``: the number of valid entries, an
    int or an integer tensor of one element (the engine's, on the device,
    so a CUDA graph reads it at every replay). With ``rolling=True``
    (sliding-window buffers) every slot < min(cache_len, S) is valid.
    ``start``: optional per-row [B] (or [1]) first valid absolute position:
    requests share one position timeline, so a slot admitted late masks
    out whatever its cache holds before its own prompt. Returns
    [B, 1, H, D] in q's type."""
    B, _, H, D = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // KVH
    scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, KVH, rep, D).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    n = torch.as_tensor(cache_len, device=q.device).reshape(()).long()
    limit = torch.clamp(n, max=S) if rolling else n
    valid = pos < limit
    if start is not None:
        if rolling:
            # slot p last written at absolute position n-1 - ((n-1-p) mod S)
            abs_pos = n - 1 - torch.remainder(n - 1 - pos, S)
        else:
            abs_pos = pos
        first = torch.as_tensor(start, device=q.device).reshape(-1, 1)
        valid = valid[None, :] & (abs_pos[None, :] >= first)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    else:
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


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


def chunk_prefill_attention(q, k, v, k_pages, v_pages, block_tables,
                            prior_len: int):
    """Attention for one prefill chunk resuming at offset ``prior_len``.

    q: [1, C, H, D] chunk queries (absolute positions prior_len + i);
    k, v: [1, C, KVH, D] the chunk's own fresh keys and values; k_pages,
    v_pages: [N, KVH, Pg, D] pools holding this row's positions
    < prior_len; block_tables: [1, MP] the row's pages in sequence order.
    ``prior_len`` is a host int (the reference traces it).

    The row's first ceil(prior_len / Pg) pages are gathered into a
    contiguous [1, prior_len, KVH, D] prefix, the chunk's keys appended,
    and ``chunked_attention`` runs causally with ``q_offset = prior_len``:
    query i sees every prior key and chunk keys j <= i — the reference's
    mask. Pool positions at or past prior_len (null tails, the chunk's own
    fresh pages, the unwritten rest of an adopted COW page) are never
    gathered. The caller writes the chunk's KV after this
    (``paged_write_chunk``). Returns [1, C, H, D]."""
    B, _, KVH, D = k.shape
    assert B == 1, "chunked prefill runs one slot at a time"
    Pg = k_pages.shape[2]
    n = -(-prior_len // Pg)
    if n:
        pages = block_tables[0, :n].long()
        kp = k_pages[pages].transpose(1, 2).reshape(1, n * Pg, KVH, D)
        vp = v_pages[pages].transpose(1, 2).reshape(1, n * Pg, KVH, D)
        k = torch.cat([kp[:, :prior_len], k], dim=1)
        v = torch.cat([vp[:, :prior_len], v], dim=1)
    return chunked_attention(q, k, v, causal=True, q_offset=prior_len)


def chunk_write_targets(pages: torch.Tensor, offs: torch.Tensor,
                        num_pages: int):
    """A chunk's write targets ``pages``/``offs`` [C] (int tensors on the
    pools' device; the sentinel ``num_pages`` marks right padding and
    COW-shared pages) -> ``(page, off, keep)`` [C] for
    ``paged_write_chunk``, computed once per chunk for every layer. As in
    ``paged_write``, a dropped row is aimed at the null page 0, offset 0,
    and writes zeros there, so the shape is fixed (the chunk can be
    captured in a CUDA graph, and nothing syncs with the host), page 0
    stays all-zero and a shared page is never touched."""
    keep = pages < num_pages
    zero = torch.zeros_like(pages)
    return (torch.where(keep, pages, zero).long(),
            torch.where(keep, offs, zero).long(), keep)


def paged_write_chunk(k_pages, v_pages, k_new, v_new, targets):
    """Write one chunk's KV into the pools, in place: chunk position i lands
    in ``(page[i], off[i])`` of ``targets`` (``chunk_write_targets``), zeros
    on the null page where ``keep[i]`` is False -- the reference's
    ``mode="drop"`` scatter over the [C] ``pages``/``offs``. k_new, v_new:
    [C, KVH, D]."""
    page, off, keep = targets
    keep3 = keep[:, None, None]
    # advanced indices split by the head slice put the row dim first
    k_pages[page, :, off] = torch.where(keep3, k_new, torch.zeros_like(k_new))
    v_pages[page, :, off] = torch.where(keep3, v_new, torch.zeros_like(v_new))


# ---------------------------------------------------------------------------
# Cross-entropy chunked over the sequence (never keeps [B, S, V] logits)
# ---------------------------------------------------------------------------
def _xent_chunk(hb, lb, mb, w_head):
    """(sum of masked nll, sum of mask) of one chunk: f32 logits from the
    upcast operands (exact, as the serving head computes them)."""
    logits = hb.float() @ w_head.float()                        # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb[..., None].long())[..., 0]
    nll = (lse - gold) * mb
    return nll.sum(), mb.sum()


def chunked_softmax_xent(h, w_head, labels, *, chunk: int = 512,
                         label_mask=None):
    """h: [B, S, D]; w_head: [D, V]; labels: [B, S] int. Returns the mean
    nll over unmasked positions (the reference's ``chunked_softmax_xent``):
    the sequence is cut into chunks of ``min(chunk, S)`` halved until it
    divides S, each chunk's f32 logits are recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), and
    the chunks' sums are added in order."""
    B, S, D = h.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    if label_mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    else:
        mask = label_mask.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        t, n = torch.utils.checkpoint.checkpoint(
            _xent_chunk, h[:, i:i + c], labels[:, i:i + c],
            mask[:, i:i + c], w_head, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
