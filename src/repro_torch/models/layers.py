"""Model substrate of the port (``repro/models/layers.py``): parameter
specs and their initializer, norms, rotary embeddings (RoPE and
Qwen2-VL's M-RoPE), projections (with the attention biases), SwiGLU and
the GELU MLP, the rolling window buffer,
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
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as KO
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A parameter's shape, initializer and logical axes (the reference's
    ``ParamSpec``). ``axes`` names each dim for the sharding rules
    (``repro_torch.sharding``), one name or ``None`` a dim; it does not
    enter ``init_one``, whose fan-in is the shape's leading dim."""
    shape: Tuple[int, ...]
    init: str = "normal"    # normal | zeros | ones | embed
    scale: float = 1.0      # fan-in style scale multiplier
    axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ParamSpec: axes {self.axes} for shape "
                             f"{self.shape}")


def stacked(spec: ParamSpec, n: int, axis_name: str = "layers") -> ParamSpec:
    """``spec`` stacked ``n`` times along a leading dim named
    ``axis_name`` (a segment's block weights)."""
    return ParamSpec((n,) + tuple(spec.shape), spec.init, spec.scale,
                     (axis_name,) + tuple(spec.axes))


# bytes of the largest f32 draw init_one makes at once: a larger leaf (the
# 47 stacked expert stacks of moonshot-v1-16b-a3b, 34.7 GB in f32 beside
# their 17.3 GB in bf16) is drawn a leading slice at a time
MAX_F32_DRAW = 1 << 34


def init_one(spec: ParamSpec, generator: torch.Generator, device,
             dtype, block: Optional[Tuple[slice, ...]] = None
             ) -> torch.Tensor:
    """The reference's initializer (``repro.models.layers._init_one``):
    zeros, ones, N(0, 0.02) for the embedding, else N(0, scale /
    sqrt(fan_in)) with fan_in = the spec's leading dim. For stacked block
    weights that leading dim is the layer count, as in the reference, so
    random-weight runs of the two packages sit in the same numeric range.
    Draws in f32 from ``generator`` (on ``device``), then casts; past
    ``MAX_F32_DRAW`` bytes, one leading slice a draw. With ``block`` (one
    slice a dim) only that block of the leaf is kept, drawn as the whole
    leaf draws (the generator advances as it would)."""
    block = block or tuple(slice(None) for _ in spec.shape)
    shape = tuple(len(range(*b.indices(n))) for b, n in zip(block,
                                                             spec.shape))
    if spec.init == "zeros":
        return torch.zeros(shape, device=device, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    std = 0.02 if spec.init == "embed" else spec.scale / math.sqrt(fan_in)
    whole = shape == tuple(spec.shape)
    if 4 * math.prod(spec.shape) <= MAX_F32_DRAW:
        w = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(std)
        if whole:
            return w.to(dtype)
        return torch.empty(shape, device=device, dtype=dtype).copy_(w[block])
    out = torch.empty(shape, device=device, dtype=dtype)
    lead = range(*block[0].indices(spec.shape[0]))
    for i in range(spec.shape[0]):
        w = torch.randn(spec.shape[1:], generator=generator, device=device,
                        dtype=torch.float32).mul_(std)
        if i in lead:
            out[i - lead.start] = w[block[1:]]
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """f32 statistics; cast back to x's type BEFORE the scale multiply, as
    the reference rounds."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm with the reference's rounding: f32 mean and (population)
    variance, cast back before the scale and bias. No model of the
    reference calls it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mu).mul(torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


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
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x's last dim by ``angles`` [..., S, 1,
    D/2] in f32, and cast back."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int, sections=(16, 24, 24)) -> list:
    """The reference's split of the ``head_dim / 2`` frequency slots into
    the (t, h, w) sections: each scaled by ``half // sum`` in integers, the
    remainder to the last ([16, 24, 24] at head_dim 128, [2, 3, 3] at
    16)."""
    half = head_dim // 2
    sec = [s * half // sum(sections) for s in sections]
    sec[-1] = half - sum(sec[:-1])
    return sec


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)):
    """Multimodal RoPE (Qwen2-VL): x [..., S, H, D], positions3 [..., S, 3]
    the (t, h, w) ids. Section i of the D/2 frequencies rotates by
    position stream i; with (p, p, p) it is RoPE at p."""
    d = x.shape[-1]
    freqs = _device_freqs(d, theta, x.device)                       # [D/2]
    parts, lo = [], 0
    for i, width in enumerate(mrope_sections(d, sections)):
        parts.append(positions3[..., :, i][..., :, None].float()
                     * freqs[lo:lo + width])
        lo += width
    return _rotate(x, torch.cat(parts, dim=-1)[..., :, None, :])


def pick_chunk(seq: int, target: int) -> int:
    """Largest power-of-two-ish chunk <= target that divides seq."""
    c = min(seq, target)
    while seq % c:
        c //= 2
    return max(c, 1)


def roll_into_window(kv_hd: torch.Tensor, total_len: int,
                     window: int) -> torch.Tensor:
    """The last W = min(window, total_len) tokens of [B, KVH, W, D] into a
    [B, KVH, window, D] rolling buffer at slot (absolute index % window),
    so a decode step at position ``len`` (writing slot ``len % window``)
    evicts exactly the oldest cached token."""
    B, KVH, W, D = kv_hd.shape
    slots = torch.arange(total_len - W, total_len,
                         device=kv_hd.device) % window
    buf = kv_hd.new_zeros((B, KVH, window, D))
    return buf.index_copy_(2, slots, kv_hd)


# ---------------------------------------------------------------------------
# Projections / MLP
# ---------------------------------------------------------------------------
def linear(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


def swiglu(x, wi, wg, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def gelu_mlp(x, wi, wo, bi=None, bo=None):
    """GELU MLP (Whisper). ``jax.nn.gelu`` defaults to the tanh
    approximation, torch's ``gelu`` to the exact erf form: the tanh form
    is asked for by name."""
    return linear(F.gelu(linear(x, wi, bi), approximate="tanh"), wo, bo)


def attn_specs(cfg, prefix_bias: bool = False) -> Dict[str, ParamSpec]:
    """q, k, v, o projections; the q/k/v biases with ``cfg.use_bias`` or
    ``prefix_bias`` (Whisper's blocks have them whatever the config
    says)."""
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, H, hd), axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KVH, hd), axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KVH, hd), axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), axes=("heads", "head_dim", "embed")),
    }
    if cfg.use_bias or prefix_bias:
        s.update({"bq": ParamSpec((H, hd), "zeros",
                                  axes=("heads", "head_dim")),
                  "bk": ParamSpec((KVH, hd), "zeros",
                                  axes=("kv_heads", "head_dim")),
                  "bv": ParamSpec((KVH, hd), "zeros",
                                  axes=("kv_heads", "head_dim"))})
    return s


def attn_qkv(p, x, positions, cfg, pos3=None, xq=None):
    """Project to q, k, v, add the biases where the block has them, and
    rotate: RoPE at ``positions``, or M-RoPE at ``pos3`` [B, S, 3] for
    ``pos_type == "mrope"`` (which raises without them, as the reference
    asserts). x: [B, S, d] -> q [B, S, H, hd], k and v [B, S, KVH, hd];
    q from ``xq`` where given (the same values, another autograd path)."""
    q = torch.einsum("bsd,dhk->bshk", x if xq is None else xq, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_type == "mrope":
        if pos3 is None:
            raise ValueError(f"{cfg.name}: mrope needs 3-component "
                             f"positions (pos3)")
        q = apply_mrope(q, pos3, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.rope_theta)
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


def decode_scores(q, k_cache):
    """The scaled f32 scores [B, KVH, rep, S] of a decode step's query
    q [B, 1, H, D] against a timeline cache block k_cache [B, KVH, S, D]."""
    B, _, H, D = q.shape
    KVH = k_cache.shape[1]
    qf = q.reshape(B, KVH, H // KVH, D).float()
    return torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float()) * (
        1.0 / math.sqrt(D))


def decode_valid(cache_len, S: int, pos, *, rolling: bool = False,
                 start=None):
    """Which timeline cache slots ``pos`` [n] (indices into a horizon of S
    slots: all of them, or one rank's block) a decode step attends, as a
    [B, n] mask ([1, n] without ``start``): slots < ``cache_len`` valid
    entries (< min(cache_len, S) in a rolling window buffer), and with
    ``start`` (per-row [B] or [1] first valid absolute position) only
    those whose absolute position is at least the row's start."""
    n = torch.as_tensor(cache_len, device=pos.device).reshape(()).long()
    valid = (pos < (torch.clamp(n, max=S) if rolling else n))[None, :]
    if start is not None:
        # a rolling slot p was last written at n-1 - ((n-1-p) mod S)
        abs_pos = n - 1 - torch.remainder(n - 1 - pos, S) if rolling \
            else pos
        first = torch.as_tensor(start, device=pos.device).reshape(-1, 1)
        valid = valid & (abs_pos[None, :] >= first)
    return valid


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
    out whatever its cache holds before its own prompt (``decode_valid``).
    Returns [B, 1, H, D] in q's type."""
    B, _, H, D = q.shape
    S = k_cache.shape[2]
    valid = decode_valid(cache_len, S, torch.arange(S, device=q.device),
                         rolling=rolling, start=start)
    s = torch.where(valid[:, None, None, :], decode_scores(q, k_cache),
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           which=None):
    """Single-token attention over a paged KV cache. q: [B, 1, H, D];
    seq_lens counts the valid tokens per row *including* the one just
    written. Goes through ``ops.paged_attention``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. ``which`` (a slice,
    ``TP.kv_for_heads``) names the KV heads of pools that hold them all
    which a tensor-parallel rank's query heads read: the kernel reads
    them in place (``kv_head0``), each serving H / their count heads."""
    B, _, H, D = q.shape
    kw = {}
    if which is not None:
        kw = dict(kv_head0=which.start, rep=H // (which.stop - which.start))
    out = KO.paged_attention(q.reshape(B, H, D), k_pages, v_pages,
                             block_tables, seq_lens, **kw)
    return out.reshape(B, 1, H, D)


def paged_write_targets(block_tables, seq_lens, Pg: int):
    """(page, offset, keep) [B] of ``paged_write``'s rows: the position
    ``seq_lens[b]`` in its page of ``block_tables[b]``, or (0, 0) and keep
    False for a dropped row (see ``paged_write``)."""
    MP = block_tables.shape[1]
    idx = (seq_lens // Pg).long()
    in_table = idx < MP
    page = block_tables.gather(1, idx.clamp(max=MP - 1)[:, None])[:, 0].long()
    keep = in_table & (page != 0)
    page = torch.where(keep, page, torch.zeros_like(page))
    off = torch.where(keep, (seq_lens % Pg).long(), torch.zeros_like(page))
    return page, off, keep


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
    page, off, keep = paged_write_targets(block_tables, seq_lens,
                                          k_pages.shape[2])
    keep3 = keep[:, None, None]
    # advanced indices split by the head slice put the batch dim first
    k_pages[page, :, off] = torch.where(keep3, k_new, torch.zeros_like(k_new))
    v_pages[page, :, off] = torch.where(keep3, v_new, torch.zeros_like(v_new))


def chunk_prefill_attention(q, k, v, k_pages, v_pages, block_tables,
                            prior_len: int, which=None):
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
    (``paged_write_chunk``). ``which`` (``TP.kv_for_heads``) picks the KV
    heads a tensor-parallel rank's query heads read where the pools hold
    them all. Returns [1, C, H, D]."""
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
    return chunked_attention(q, TP.take_kv(k, which, 2),
                             TP.take_kv(v, which, 2), causal=True,
                             q_offset=prior_len)


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


def _xent_chunk_split(hb, lb, mb, w_head, lo: int):
    """``_xent_chunk`` over a vocab-split head: ``w_head`` holds this
    rank's columns [lo, lo + V / M) of the model axis's vocab. The
    logsumexp's shift is the max over the group of each rank's row max
    (``TP.max_model``, no gradient: the logsumexp does not depend on it),
    the sum of exponentials and the gold logit (picked where the label is
    in this rank's block, else 0) are summed over the group in one
    ``TP.reduce_model``; the [B, c, V] logits are never gathered."""
    logits = hb.float() @ w_head.float()                        # [B, c, Vl]
    with torch.no_grad():
        shift = TP.max_model(logits.amax(-1))                   # [B, c]
    sumexp = torch.exp(logits - shift[..., None]).sum(-1)
    local = lb.long() - lo
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = logits.gather(-1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    gold = torch.where(mine, gold, torch.zeros_like(gold))
    sumexp, gold = TP.reduce_model(torch.stack([sumexp, gold])).unbind(0)
    nll = (torch.log(sumexp) + shift - gold) * mb
    return nll.sum(), mb.sum()


def chunked_softmax_xent(h, w_head, labels, *, chunk: int = 512,
                         label_mask=None, vocab: Optional[int] = None,
                         seq: bool = False):
    """h: [B, S, D]; w_head: [D, V]; labels: [B, S] int. Returns the mean
    nll over unmasked positions (the reference's ``chunked_softmax_xent``):
    the sequence is cut into chunks of ``min(chunk, S)`` halved until it
    divides S, each chunk's f32 logits are recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), and
    the chunks' sums are added in order. On a rank of a model axis whose
    ``w_head`` holds a block of the ``vocab`` columns, each chunk is the
    vocab-parallel cross entropy (``_xent_chunk_split``) and ``h`` enters
    it through ``TP.copy_to_model``. With ``seq`` (a sequence split) ``h``
    is this rank's block of the sequence, gathered whole first
    (``TP.enter``)."""
    split = vocab is not None and TP.split(w_head.shape[1], vocab)
    h = TP.enter(h, split, seq)
    B, S, D = h.shape
    c = pick_chunk(S, chunk)
    fn, recompute = _xent_chunk, R.recompute_context()
    if split:
        fn = functools.partial(
            _xent_chunk_split, lo=TP.current().index * w_head.shape[1])
    if label_mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    else:
        mask = label_mask.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        t, n = torch.utils.checkpoint.checkpoint(
            fn, h[:, i:i + c], labels[:, i:i + c],
            mask[:, i:i + c], w_head, use_reentrant=False,
            context_fn=recompute)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
