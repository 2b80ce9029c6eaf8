"""Decoder stacks of the port (``repro/models/transformer.py``): the
generic ``StackedLM`` over one or more homogeneous segments, the dense
family, and the VLM backbone (``VlmLM``: M-RoPE and a stub patch
frontend). The MoE family (``models/moe.py``, with its dense stem),
Hymba (``models/hymba.py``) and xLSTM (``models/xlstm.py``, one segment
``"pairs"`` of recurrent blocks) build on the same machinery.

Parameters are a plain dict with the reference's tree and layouts: each
segment's block weights stacked along a leading layer dim under its name
(``"blocks"``, and ``"stem"`` ahead of it for a DeepSeek-style MoE;
``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, an MoE block's ``moe.wi``
``[L, E, d, dff]``, ...), tied embeddings for llama. A parameter tree
converted from the JAX package (``repro_torch.weights``) therefore drops
in as is. The block loop is a Python loop over segments and layers (the
reference's ``lax.scan`` per segment). Caches are keyed by segment name
too, each updated in place: the paged pools, per-segment ``(k, v)``
tensors ``[L, N, KVH, page_size, D]``, and the reference's
shared-position timeline, a per-segment tree of per-layer leaves stacked
on a leading layer dim: ``(k, v)`` ``[L, B, KVH, S, D]`` (or, with
``cache_quant``, int8 payloads and f32 per-(head, channel) scales
``(k_q8, v_q8, k_s, v_s)``, the scales ``[L, KVH, D]``; a Hymba layer adds
its recurrent state), beside ``"len"`` (one int32 for every row) and an
optional per-row ``"start"`` [B]. A sliding-window model's timeline
buffers hold the window, written at ``len % window``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import leaves
from . import layers as L
from .layers import ParamSpec, init_one



def _as_index(x, device) -> torch.Tensor:
    """Host ints or an int tensor -> an int64 tensor on ``device``. A host
    value is copied here, which a CUDA graph cannot capture: the engine
    passes tensors already on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _last_positions(lens, device) -> torch.Tensor:
    """int64 [n] positions of each row's last valid token, ``lens - 1``."""
    return _as_index(lens, device).reshape(-1) - 1


def quantize_kv(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """t: [..., D] -> int8 against a per-(head, channel) scale broadcast
    over the rest (round half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(t.float() / scale), -127, 127).to(
        torch.int8)


def dequantize_kv(t: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (t.float() * scale).to(dtype)


def default_kv_cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
                          quant: bool = False, dtype=torch.bfloat16):
    """Per-layer timeline KV cache spec (no leading layer dim): ``(shape,
    dtype)`` of k and v ``[batch, KVH, S, D]``, and with ``quant`` int8
    payloads plus f32 per-(head, channel) scales ``[KVH, D]`` (half the
    payload bytes). S is ``max_seq``, or the window of a sliding-window
    model (rolling slots: absolute index % window)."""
    S = cfg.sliding_window if cfg.sliding_window else max_seq
    kv = ((batch, cfg.num_kv_heads, S, cfg.head_dim),
          torch.int8 if quant else dtype)
    if quant:
        sc = ((cfg.num_kv_heads, cfg.head_dim), torch.float32)
        return (kv, kv, sc, sc)
    return (kv, kv)


# logical axes of one layer's timeline k or v [B, KVH, S, D] (the
# reference's), and of the int8 cache's per-(head, channel) scales
KV_AXES = ("act_kv_batch", "act_kv_heads", "act_kv_seq", None)
KV_SCALE_AXES = ("act_kv_heads", None)


def default_kv_cache_axes(quant: bool = False):
    """Logical axes of ``default_kv_cache_spec``'s leaves, in its tree."""
    if quant:
        return (KV_AXES, KV_AXES, KV_SCALE_AXES, KV_SCALE_AXES)
    return (KV_AXES, KV_AXES)


def dense_block_specs(cfg: ArchConfig,
                      d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff
    return {
        "ln1": ParamSpec((d,), "ones", axes=("embed",)),
        "ln2": ParamSpec((d,), "ones", axes=("embed",)),
        "attn": L.attn_specs(cfg),
        "mlp": {
            "wi": ParamSpec((d, ff), axes=("embed", "mlp")),
            "wg": ParamSpec((d, ff), axes=("embed", "mlp")),
            "wo": ParamSpec((ff, d), axes=("mlp", "embed")),
        },
    }


def _map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def _at(tree, l: int):
    """Layer ``l`` of a tree of stacked leaves (block weights, or a
    segment's cache), as views."""
    if isinstance(tree, dict):
        return {k: _at(v, l) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_at(v, l) for v in tree)
    return tree[l]


def _unbind(tree, n: int):
    """The ``n`` layers of a tree of stacked block weights, as views from
    one ``torch.unbind`` per leaf."""
    if isinstance(tree, dict):
        kids = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: kids[k][l] for k in kids} for l in range(n)]
    return torch.unbind(tree, 0)


def _stack(layers: List[Any]):
    """Per-layer cache trees (tuples of tensors) -> one tree of leaves
    stacked on a new leading layer dim."""
    first = layers[0]
    if isinstance(first, (tuple, list)):
        return tuple(_stack([t[i] for t in layers])
                     for i in range(len(first)))
    return torch.stack(layers)


def is_spec(x) -> bool:
    """A cache spec's leaf: ``(shape, dtype)``."""
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[1], torch.dtype)


def map_specs(fn, tree):
    """``fn`` over the ``(shape, dtype)`` leaves of a cache spec tree."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return tuple(map_specs(fn, v) for v in tree)


def is_axes(x) -> bool:
    """A cache axes tree's leaf: a tuple of axis names (or ``None``)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, tree):
    """``fn`` over the leaves of a cache axes tree."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    return tuple(map_axes(fn, v) for v in tree)


def _window_kv(k: torch.Tensor, v: torch.Tensor, window: int):
    """A prefill's k, v [B, S, KVH, D] -> the layer's timeline cache
    entries [B, KVH, S, D]; with a window, the last ``min(window, S)``
    positions rolled into a [B, KVH, window, D] buffer."""
    S = k.shape[1]
    kk, vv = k.transpose(1, 2), v.transpose(1, 2)
    if window:
        keep = min(window, S)
        kk = L.roll_into_window(kk[:, :, S - keep:], S, window)
        vv = L.roll_into_window(vv[:, :, S - keep:], S, window)
    return kk, vv


class AttnBlock:
    """One pre-norm block of the dense, MoE and VLM families (and of the
    MoE family's dense stem): attention (RoPE or M-RoPE, GQA, an optional
    sliding window), then the FFN, SwiGLU or ``ffn(p, h, train)`` (the MoE
    FFN). One method a path; each writes its layer of a cache in place.
    ``cache_quant`` keeps the timeline cache in int8 with per-(head,
    channel) scales."""

    paged = True                # has the paged-cache paths

    def __init__(self, cfg: ArchConfig, cache_quant: bool = False,
                 ffn: Optional[Callable] = None):
        self.cfg, self.cache_quant, self.ffn = cfg, cache_quant, ffn
        self.window = cfg.sliding_window
        self.rolling = bool(self.window)

    def mlp(self, p, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = L.rmsnorm(x, p["ln2"], self.cfg.norm_eps)
        if self.ffn is not None:
            return x + self.ffn(p, h, train)
        m = p["mlp"]
        return x + L.swiglu(h, m["wi"], m["wg"], m["wo"])

    def forward(self, p, x, positions, pos3=None, train: bool = False):
        """The block over a whole sequence: causal (windowed) attention
        through ``L.chunked_attention`` (the flash kernel on the card),
        then the FFN. Returns (x, k, v) with k, v [B, S, KVH, D]."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, cfg, pos3)
        ctx = L.chunked_attention(q, k, v, causal=True, window=self.window)
        x = x + L.attn_out(p["attn"], ctx)
        return self.mlp(p, x, train), k, v

    def train(self, p, x, positions, pos3=None) -> torch.Tensor:
        return self.forward(p, x, positions, pos3, train=True)[0]

    def prefill(self, p, x, positions, pos3=None):
        """(x, the layer's timeline cache entries ``(k, v)`` [B, KVH, S, D],
        windowed as ``_window_kv``)."""
        x, k, v = self.forward(p, x, positions, pos3)
        return x, _window_kv(k, v, self.window)

    # -- the timeline decode ---------------------------------------------------
    @staticmethod
    def kv_of(cache):
        """The KV part of a layer's (or a segment's) timeline cache."""
        return cache

    def decode_slot(self, cache_len: torch.Tensor, body) -> torch.Tensor:
        """The [1] slot a decode step at position ``cache_len`` writes into
        the segment's cache ``body`` of S positions: ``len % S`` in a
        rolling window buffer, else ``min(len, S - 1)``."""
        S = self.kv_of(body)[0].shape[3]
        n = cache_len.reshape(1).long()
        return torch.remainder(n, S) if self.rolling else \
            torch.clamp(n, max=S - 1)

    def attend_decode(self, q, k, v, kv, cache_len, slot, start, rows):
        """Write this step's k, v [b, 1, KVH, D] at ``slot`` of the layer's
        ``kv`` rows ``rows`` (int8 against the layer's scales when
        quantized), in place, and attend over ``cache_len + 1`` positions
        from each row's ``start`` (``L.decode_attention``)."""
        k, v = k.transpose(1, 2), v.transpose(1, 2)         # [b, KVH, 1, D]
        if self.cache_quant:
            k_q, v_q, k_s, v_s = kv
            sK, sV = k_s[:, None, :], v_s[:, None, :]       # [KVH, 1, D]
            k_q, v_q = k_q[rows], v_q[rows]
            k_q.index_copy_(2, slot, quantize_kv(k, sK))
            v_q.index_copy_(2, slot, quantize_kv(v, sV))
            kc, vc = dequantize_kv(k_q, sK), dequantize_kv(v_q, sV)
        else:
            kc, vc = kv[0][rows], kv[1][rows]
            kc.index_copy_(2, slot, k)
            vc.index_copy_(2, slot, v)
        return L.decode_attention(q, kc, vc, cache_len + 1,
                                  rolling=self.rolling, start=start)

    def decode(self, p, x, positions, pos3, cache, cache_len, slot, start,
               rows):
        """One timeline decode step of rows ``rows`` of this layer's cache
        ``cache`` (views into the segment's stacked leaves)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, cfg, pos3)
        ctx = self.attend_decode(q, k, v, cache, cache_len, slot, start,
                                 rows)
        x = x + L.attn_out(p["attn"], ctx)
        return self.mlp(p, x)

    # -- the paged paths -------------------------------------------------------
    def decode_paged(self, p, x, positions, pos3, pools, bt, sl, sl_next):
        """One paged decode step: write the new K/V into this layer's
        pools ``(k, v)`` [N, KVH, Pg, D] in place and attend over
        ``sl_next`` tokens (the paged kernel on the card)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, cfg, pos3)
        L.paged_write(pools[0], pools[1], k[:, 0], v[:, 0], bt, sl)
        ctx = L.paged_decode_attention(q, pools[0], pools[1], bt, sl_next)
        x = x + L.attn_out(p["attn"], ctx)
        return self.mlp(p, x)

    def prefill_chunk(self, p, x, positions, pos3, pools, bt, offset: int,
                      targets):
        """One prefill chunk: attend over the gathered prefix plus the chunk
        (``L.chunk_prefill_attention``), then write the chunk's KV into
        this layer's pools, in place."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, cfg, pos3)
        ctx = L.chunk_prefill_attention(q, k, v, pools[0], pools[1], bt,
                                        offset)
        L.paged_write_chunk(pools[0], pools[1], k[0], v[0], targets)
        x = x + L.attn_out(p["attn"], ctx)
        return self.mlp(p, x)


@dataclasses.dataclass
class Segment:
    """A homogeneous run of ``n`` blocks with stacked params (the
    reference's ``Segment``): ``name`` keys its params and its caches,
    ``specs_fn()`` gives one block's param specs, ``block`` runs one block
    on every path, ``cache_spec_fn(batch, max_seq, dtype)`` one layer's
    timeline cache spec (a tree of ``(shape, dtype)``), ``cache_axes`` its
    logical axes in the same tree (shape-free, as the reference's)."""

    name: str
    n: int
    specs_fn: Callable[[], Dict[str, Any]]
    block: AttnBlock
    cache_spec_fn: Callable
    cache_axes: Any


class StackedLM:
    """A causal LM whose body is one or more homogeneous segments
    (the reference's ``StackedLM``): embedding (and, for a VLM, its
    frontend), each segment's blocks in order, final norm, tied (or
    separate) output head. ``remat`` recomputes each block in the backward
    of ``loss_fn``, as the reference's default does. ``cache_quant`` keeps
    the timeline cache in int8 with per-(head, channel) scales set by
    ``prefill_fn``. ``paged_ok`` (set by the builders, as the reference's)
    says whether the paged-cache paths apply."""

    def __init__(self, cfg: ArchConfig, segments: List[Segment],
                 remat: bool = True, cache_quant: bool = False,
                 paged_ok: bool = False):
        self.cfg = cfg
        self.segments = segments
        self.remat = remat
        self.cache_quant = cache_quant
        self.paged_ok = paged_ok
        # layer l of the whole stack -> (its segment, its index there)
        self._where = [(seg, i) for seg in segments for i in range(seg.n)]

    # -- parameters --------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        c = self.cfg
        specs: Dict[str, Any] = {
            "embed": ParamSpec((c.vocab_size, c.d_model), "embed",
                               axes=("vocab", "embed")),
            "ln_f": ParamSpec((c.d_model,), "ones", axes=("embed",)),
        }
        if not c.tie_embeddings:
            specs["head"] = ParamSpec((c.d_model, c.vocab_size),
                                      axes=("embed", "vocab"))
        for seg in self.segments:
            specs[seg.name] = _map_specs(
                lambda s, n=seg.n: L.stacked(s, n), seg.specs_fn())
        return specs

    def init_params(self, generator: torch.Generator, device, dtype):
        return _map_specs(lambda s: init_one(s, generator, device, dtype),
                          self.param_specs())

    # -- embedding / frontend / head -----------------------------------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def _fuse_frontend(self, params, x: torch.Tensor, batch) -> torch.Tensor:
        """A modality frontend's fusion into the embedded tokens (none
        here; ``VlmLM`` adds its patches)."""
        return x

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """h [B, d] -> f32 logits [B, V]. The reference asks XLA for f32
        accumulation over its bf16 operands (``preferred_element_type``);
        upcasting the operands is exact, so the head runs in f32."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return h.float() @ w.float()

    def head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and output head at the last position: x [B, S, d] ->
        f32 logits [B, V]."""
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return self.logits(params, x[:, -1])

    def _layer(self, params, l: int) -> Dict[str, Any]:
        """Layer ``l`` of the whole stack's block weights."""
        seg, i = self._where[l]
        return _at(params[seg.name], i)

    @property
    def served_segment(self) -> Segment:
        """The segment a serving engine, its backends and a pipeline stage
        run: the model's only one (its name keys the cache body)."""
        if len(self.segments) != 1:
            raise ValueError(
                f"{self.cfg.name}: a layer range of one cache body needs a "
                f"single homogeneous segment, not "
                f"{[s.name for s in self.segments]}")
        return self.segments[0]

    def _span(self, tree, start: int, end: Optional[int]):
        """``(start, end, at)`` for layers [start, end) of the served
        segment (``end`` None: to its last), where ``tree`` -- the
        segment's block weights or cache body -- holds either every layer
        or exactly those (a pipeline rank's own, from
        ``PipelinedDecoder.stage_params``): layer l sits at ``l - at``."""
        n = self.served_segment.n
        end = n if end is None else end
        if not 0 <= start < end <= n:
            raise ValueError(f"layer range [{start}, {end}) of {n}")
        have = leaves(tree)[0].shape[0]
        if have == n:
            return start, end, 0
        if have == end - start:
            return start, end, start
        raise ValueError(f"layers [{start}, {end}) of a stack of {have}")

    def _entry(self, params, batch) -> torch.Tensor:
        """What enters the first layer of a range: the embedded tokens
        (with the frontend) at layer 0, else ``batch["hidden"]``, the
        hidden state the previous range returned."""
        if "hidden" in batch:
            return batch["hidden"]
        return self._fuse_frontend(params, self.embed(params,
                                                      batch["tokens"]),
                                   batch)

    def _block(self, p, x, positions, train: bool = False, pos3=None):
        """One block of the last segment (the served one) over a whole
        sequence: ``AttnBlock.forward``'s (x, k, v), k and v
        [B, S, KVH, D]."""
        return self.segments[-1].block.forward(p, x, positions, pos3, train)

    def _blocks(self, params, batch, train: bool = False,
                hidden: Optional[list] = None, start: int = 0,
                end: Optional[int] = None):
        """Embed ``batch["tokens"]`` [B, S] (with the frontend's
        ``patches``), at ``batch["positions"]`` or 0..S-1 (and ``pos3`` for
        M-RoPE), and run every segment's blocks. Returns (x [B, S, d]
        before the final norm, {segment: [each layer's timeline cache]})
        when serving, an empty dict in training. With a layer range
        ``[start, end)`` other than the whole stack (one segment only;
        see ``_span``), only those layers run: from ``batch["hidden"]``
        where ``start > 0``, and the cache holds those layers. In training with
        ``remat`` each block runs under ``torch.utils.checkpoint`` (the
        reference's ``jax.checkpoint`` of each scan step) while autograd
        records: its activations are recomputed in the backward, so the
        flash kernel runs twice a layer. The stacked block weights are
        unbound once, so their gradient is one stack of the layers'.
        ``hidden``, when given, receives the embedding and then each
        block's output."""
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        pos3 = batch.get("pos3")
        x = self._entry(params, batch)
        if hidden is not None:
            hidden.append(x)
        caches = {}
        span = None if start == 0 and end is None else \
            self._span(params[self.served_segment.name], start, end)
        for seg in self.segments:
            blk, layers = seg.block, []
            if span is None:
                stack = _unbind(params[seg.name], seg.n)
            else:
                lo, hi, at = span
                stack = _unbind(params[seg.name],
                                leaves(params[seg.name])[0].shape[0])
                stack = stack[lo - at:hi - at]
            for p in stack:
                if not train:
                    x, c = blk.prefill(p, x, positions, pos3)
                    layers.append(c)
                elif self.remat and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(
                        blk.train, p, x, positions, pos3,
                        use_reentrant=False)
                else:
                    x = blk.train(p, x, positions, pos3)
                if hidden is not None:
                    hidden.append(x)
            if layers:
                caches[seg.name] = layers
        return x, caches

    # -- public: loss ----------------------------------------------------------
    def loss_fn(self, params, batch):
        """Mean next-token nll of ``batch`` (``tokens``, ``labels`` [B, S],
        optional ``label_mask``, ``positions``, and a VLM's ``patches`` /
        ``pos3``): every block in train mode, the final norm, and
        ``chunked_softmax_xent`` against the tied embedding or ``head``
        (the reference's ``StackedLM.loss_fn``)."""
        x, _ = self._blocks(params, batch, train=True)
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return L.chunked_softmax_xent(x, w, batch["labels"],
                                      label_mask=batch.get("label_mask"))

    # -- public: per-layer hidden states (privacy profiling) ------------------
    @torch.no_grad()
    def hidden_states_fn(self, params, batch):
        """[L+1, B, S, D] hidden states of ``batch["tokens"]`` [B, S] in the
        param dtype: the embedding (with the frontend), then each block's
        output over every segment, every block in train mode (an MoE block
        drops at capacity) and no final norm, as the reference's code
        computes them (its docstring says ``[total_blocks, ...]``; its code
        prepends the embedding, which ``core.privacy.lm_similarity_profile``
        reads as entry 0). Runs without autograd, so each layer's attention
        is the flash kernel's forward on a CUDA tensor."""
        hidden = []
        self._blocks(params, {k: v for k, v in batch.items()
                              if k != "positions"}, train=True, hidden=hidden)
        return torch.stack(hidden)

    # -- public: batched right-padded prefill --------------------------------
    def _prefill(self, params, batch, start: int = 0,
                 end: Optional[int] = None):
        """Every block over right-padded prompts ``batch["tokens"]`` [B, S].
        Returns (x [B, S, d] after the final norm, {segment: its timeline
        cache, each leaf stacked on a leading layer dim}): an attention
        segment's ``(k, v)`` [L, B, KVH, S, D]. Over a layer range
        (``_blocks``) that stops short of the last layer, x is the hidden
        state that leaves the range, without the norm."""
        x, layers = self._blocks(params, batch, start=start, end=end)
        if self._is_last(end):
            x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return x, {name: _stack(ls) for name, ls in layers.items()}

    def _is_last(self, end: Optional[int]) -> bool:
        return end is None or end == self.served_segment.n

    def prefill_fn(self, params, batch):
        """Whole-batch prefill into a fresh timeline cache: ``tokens``
        [B, S], every position real (a VLM's ``patches`` and ``pos3`` with
        them). Returns (f32 logits [B, V] at the last position, {segment:
        its cache, "len": S}); with ``cache_quant`` each segment holds
        ``(k_q8, v_q8, k_s, v_s)``, each layer's scales ``max |kv| / 127 +
        1e-6`` over the batch and the sequence per (head, channel), the
        only call that sets them."""
        tokens = batch["tokens"]
        x, caches = self._prefill(params, batch)
        if self.cache_quant:
            for name, (kk, vv) in list(caches.items()):
                k_s, v_s = (t.float().abs().amax(dim=(1, 3)) / 127.0 + 1e-6
                            for t in (kk, vv))              # [L, KVH, D]
                caches[name] = (quantize_kv(kk, k_s[:, None, :, None]),
                                quantize_kv(vv, v_s[:, None, :, None]),
                                k_s, v_s)
        caches["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        return self.logits(params, x[:, -1]), caches

    def prefill_at_fn(self, params, batch, start: int = 0,
                      end: Optional[int] = None):
        """Whole-prompt prefill for paged admission: ``tokens`` [B, S_pad]
        right-padded, ``prompt_len`` the true length (a host int, or an
        int64 tensor of one element on the tokens' device, as the engine
        passes it so that a CUDA graph per bucket serves every length).
        Causal attention hides the padding; logits are read at
        ``prompt_len - 1``. Returns (logits [B, V] f32, {segment: (k, v)})
        with k, v [L, B, KVH, S_pad, D] — only the first ``prompt_len``
        positions are meaningful. ``[start, end)`` runs those layers only
        (a pipeline stage's, ``_blocks``): the embedding only where
        ``start == 0``, the norm and head only where ``end`` is the last
        layer, else it returns the hidden state [B, S_pad, d] in place of
        the logits; the whole range is the whole function."""
        tokens = batch["tokens"]
        x, caches = self._prefill(params, batch, start, end)
        if not self._is_last(end):
            return x, caches
        last = _last_positions(batch["prompt_len"], tokens.device)
        return self.logits(params, x.index_select(1, last)[:, 0]), caches

    def prefill_packed_fn(self, params, batch, start: int = 0,
                          end: Optional[int] = None):
        """``prefill_at_fn`` over K prompts at once: ``tokens`` [K, S_pad]
        holds K right-padded prompts, ``prompt_lens`` their true lengths
        (K host ints, or an int64 [K] tensor on the tokens' device). Rows
        never attend to each other and causal attention hides each row's
        padding, so row b's logits — read at its own ``prompt_lens[b] - 1``
        — and cache positions < ``prompt_lens[b]`` are those of a solo
        ``prefill_at_fn`` call at the same bucket. ``[start, end)`` as in
        ``prefill_at_fn``."""
        tokens = batch["tokens"]
        K, S = tokens.shape
        x, caches = self._prefill(params, batch, start, end)
        if not self._is_last(end):
            return x, caches
        rows = torch.arange(K, device=tokens.device) * S
        last = rows + _last_positions(batch["prompt_lens"], tokens.device)
        return self.logits(params, x.flatten(0, 1).index_select(0, last)), \
            caches

    # -- public: chunked prefill (resume at an offset, pools carried in) -----
    def prefill_chunk_fn(self, params, pools, batch, start: int = 0,
                         end: Optional[int] = None):
        """One prefill chunk against the paged cache: ``tokens`` [1, C] is
        chunk [offset, offset + chunk_len) of a prompt, right-padded to the
        engine's chunk size C; ``pools`` {segment: (k, v)} the
        [L, N, KVH, Pg, D] pools already holding positions < ``offset``
        (earlier chunks, or adopted COW-shared pages); ``bt_row`` [1, MP]
        the slot's block table so far; ``pages``/``offs`` [C] write targets
        for the chunk's own KV (the sentinel ``N`` for padding and shared
        pages). ``offset`` is a host int: it sets the gathered prefix and
        the flash kernel's ``q_offset``, so a CUDA graph is captured per
        offset. ``chunk_len``, ``pages`` and ``offs`` are host values or
        int tensors on the tokens' device (the engine's, static buffers
        under a graph). Each block attends over the gathered prefix plus
        the chunk (``L.chunk_prefill_attention``) and then writes the
        chunk's KV into its layer of the pools, in place. Returns (f32
        logits [1, V] at the chunk's last valid token, the same pools).
        ``[start, end)`` as in ``prefill_at_fn`` (params and pools may
        hold those layers only)."""
        tokens = batch["tokens"]
        C = tokens.shape[1]
        offset = int(batch["offset"])
        positions = offset + torch.arange(C, device=tokens.device)[None, :]
        pos3 = batch.get("pos3")
        bt = batch["bt_row"]
        targets = L.chunk_write_targets(
            _as_index(batch["pages"], tokens.device),
            _as_index(batch["offs"], tokens.device),
            pools[self.segments[0].name][0].shape[1])
        x = batch["hidden"] if "hidden" in batch else \
            self.embed(params, tokens)
        for seg in self.segments:
            pool = pools[seg.name]
            lo, hi, at_p = (0, seg.n, 0) if start == 0 and end is None \
                else self._span(params[seg.name], start, end)
            at_c = 0 if (lo, hi) == (0, seg.n) \
                else self._span(pool, lo, hi)[2]
            for l in range(lo, hi):
                x = seg.block.prefill_chunk(
                    _at(params[seg.name], l - at_p), x, positions, pos3,
                    _at(pool, l - at_c), bt, offset, targets)
        if not self._is_last(end):
            return x, pools
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        last = _last_positions(batch["chunk_len"], tokens.device)
        return self.logits(params, x.index_select(1, last)[:, 0]), pools

    # -- public: timeline decode ----------------------------------------------
    def decode_timeline_blocks(self, params, body, x: torch.Tensor,
                               cache_len: torch.Tensor,
                               start: Optional[torch.Tensor] = None,
                               lo: int = 0, hi: Optional[int] = None,
                               rows: slice = slice(None), pos3=None,
                               seg: Optional[Segment] = None
                               ) -> torch.Tensor:
        """Blocks ``[lo, hi)`` of segment ``seg`` (default: the only one)
        in one timeline decode step, for batch rows ``rows`` of the
        segment's cache ``body`` (``(k, v)`` [L, B, KVH, S, D],
        ``(k_q8, v_q8, k_s, v_s)``, a Hymba layer's tree or an xLSTM pair's
        state). Every row sits at the shared position ``cache_len`` (an int
        tensor of one element on the device; ``pos3`` [b, 1, 3] for
        M-RoPE): each block writes its new K/V at the slot ``decode_slot``
        names (None for a block without KV), in place, and
        attends over ``cache_len + 1`` positions from each row's ``start``
        (the rows' [b] slice, or None). ``x`` [b, 1, d] enters block
        ``lo``; returns what leaves block ``hi - 1``. ``decode_fn`` runs
        every segment on every row; a pipeline stage runs its range of a
        single-segment model on its microbatch's rows."""
        seg = seg or self.served_segment
        blk = seg.block
        hi = seg.n if hi is None else hi
        positions = cache_len.reshape(1, 1)
        slot = blk.decode_slot(cache_len, body)
        for l in range(lo, hi):
            x = blk.decode(_at(params[seg.name], l), x, positions, pos3,
                           _at(body, l), cache_len, slot, start, rows)
        return x

    def decode_fn(self, params, cache, batch, start: int = 0,
                  end: Optional[int] = None):
        """One decode step over the timeline cache: ``batch["tokens"]``
        [B, 1] at the shared position ``cache["len"]`` (``batch["pos3"]``
        [B, 1, 3] for M-RoPE), masked per row from ``cache["start"]`` when
        the cache has one (the serving engine's continuous batching). Every
        segment's body and ``len`` are updated in place (``len`` advances
        by one) and the same cache dict is returned with the f32 logits
        [B, V]. ``[start, end)`` runs those layers of the served segment
        only (params and body may hold those layers only): from
        ``batch["hidden"]`` where ``start > 0``, and returning the hidden
        state [B, 1, d] in place of the logits where ``end`` is not the
        last layer; ``len`` advances either way."""
        n = cache["len"]
        if start == 0 and end is None:
            x = self.embed(params, batch["tokens"])              # [B, 1, d]
            for seg in self.segments:
                x = self.decode_timeline_blocks(
                    params, cache[seg.name], x, n, cache.get("start"),
                    pos3=batch.get("pos3"), seg=seg)
        else:
            seg = self.served_segment
            lo, hi, at = self._span(params[seg.name], start, end)
            if self._span(cache[seg.name], lo, hi)[2] != at:
                raise ValueError("params and cache hold different layers")
            x = batch["hidden"] if lo > 0 else \
                self.embed(params, batch["tokens"])
            x = self.decode_timeline_blocks(
                params, cache[seg.name], x, n, cache.get("start"),
                lo - at, hi - at, pos3=batch.get("pos3"), seg=seg)
            if not self._is_last(end):
                n.add_(1)
                return x, cache
        logits = self.head(params, x)
        n.add_(1)
        return logits, cache

    # -- public: paged decode ------------------------------------------------
    def decode_blocks(self, params, pools, x: torch.Tensor,
                      block_tables: torch.Tensor, seq_lens: torch.Tensor,
                      start: int = 0, end: Optional[int] = None, pos3=None,
                      seg: Optional[Segment] = None) -> torch.Tensor:
        """Blocks ``[start, end)`` of segment ``seg`` (default: the only
        one) in one paged decode step, for the rows of ``block_tables``
        [B, MP] / ``seq_lens`` [B] (positions are the per-row ``seq_lens``,
        0-based; ``pos3`` [B, 1, 3] for M-RoPE). ``x`` [B, 1, d] is the
        residual stream entering block ``start``; returns the one leaving
        block ``end - 1``. Each block writes its new K/V into its own layer
        of the segment's pools ``(k, v)`` [L, N, KVH, Pg, D] in place and
        attends over ``seq_lens + 1`` tokens. ``decode_paged_fn`` runs
        every segment; a pipeline stage runs its own range on its
        microbatch's rows."""
        seg = seg or self.served_segment
        end = seg.n if end is None else end
        positions = seq_lens[:, None]
        sl_next = seq_lens + 1
        for l in range(start, end):
            x = seg.block.decode_paged(_at(params[seg.name], l), x,
                                       positions, pos3, _at(pools, l),
                                       block_tables, seq_lens, sl_next)
        return x

    def decode_paged_fn(self, params, cache, batch):
        """One decode step over the paged cache. ``cache`` holds each
        segment's pools ``(k, v)`` ``[L, N, KVH, Pg, D]``, ``block_tables``
        [B, MP] and ``seq_lens`` [B] (int32). Positions are per-row and
        0-based (``batch["pos3"]`` for M-RoPE). The pools and ``seq_lens``
        are updated in place (rows that hold a sequence advance by one;
        idle rows stay 0) and the same cache dict is returned with the f32
        logits."""
        bt, sl = cache["block_tables"], cache["seq_lens"]
        x = self.embed(params, batch["tokens"])          # [B, 1, d]
        for seg in self.segments:
            x = self.decode_blocks(params, cache[seg.name], x, bt, sl,
                                   pos3=batch.get("pos3"), seg=seg)
        logits = self.head(params, x)
        sl.copy_(torch.where(sl > 0, sl + 1, sl))
        return logits, cache

    # -- caches --------------------------------------------------------------
    def init_cache_specs(self, batch_size: int, max_seq: int,
                         dtype) -> Dict[str, Any]:
        """Shapes and types of the timeline cache: each segment's tree, its
        leaves stacked on a leading layer dim, and ``len``."""
        specs: Dict[str, Any] = {
            seg.name: map_specs(lambda s, n=seg.n: ((n,) + s[0], s[1]),
                                seg.cache_spec_fn(batch_size, max_seq,
                                                  dtype))
            for seg in self.segments}
        specs["len"] = ((), torch.int32)
        return specs

    def init_cache_axes(self) -> Dict[str, Any]:
        """Logical axes of ``init_cache_specs``'s leaves, in its tree (the
        second half of the reference's ``init_cache_specs``): each layer's
        axes behind ``"layers"``, and ``()`` for ``len``."""
        axes: Dict[str, Any] = {
            seg.name: map_axes(lambda a: ("layers",) + a, seg.cache_axes)
            for seg in self.segments}
        axes["len"] = ()
        return axes

    def init_paged_cache_specs(self, num_slots: int, num_pages: int,
                               page_size: int, pages_per_slot: int,
                               dtype) -> Dict[str, Any]:
        """Shapes and types of the paged cache: per-segment page pools
        (stacked layer dim), one block table [num_slots, pages_per_slot]
        and per-slot seq_lens. Page 0 is the reserved null page."""
        c = self.cfg
        specs: Dict[str, Any] = {}
        for seg in self.segments:
            pool = ((seg.n, num_pages, c.num_kv_heads, page_size,
                     c.head_dim), dtype)
            specs[seg.name] = (pool, pool)
        specs["block_tables"] = ((num_slots, pages_per_slot), torch.int32)
        specs["seq_lens"] = ((num_slots,), torch.int32)
        return specs


# ---------------------------------------------------------------------------
# Dense family
# ---------------------------------------------------------------------------
def _attn_segment(cfg: ArchConfig, name: str, n: int, cache_quant: bool,
                  d_ff: Optional[int] = None,
                  ffn: Optional[Callable] = None,
                  specs_fn: Optional[Callable] = None) -> Segment:
    """A segment of attention blocks (dense SwiGLU, or ``ffn``)."""
    def cache_fn(batch, max_seq, dtype):
        return default_kv_cache_spec(cfg, batch, max_seq, cache_quant, dtype)

    return Segment(name, n, specs_fn or (lambda: dense_block_specs(cfg,
                                                                   d_ff)),
                   AttnBlock(cfg, cache_quant, ffn), cache_fn,
                   default_kv_cache_axes(cache_quant))


def build_dense(cfg: ArchConfig, remat: bool = True,
                cache_quant: bool = False) -> StackedLM:
    return StackedLM(cfg, [_attn_segment(cfg, "blocks", cfg.num_layers,
                                         cache_quant)],
                     remat, cache_quant,
                     paged_ok=not (cache_quant or cfg.sliding_window))


# ---------------------------------------------------------------------------
# VLM backbone: dense blocks + patch-embedding fusion + M-RoPE
# ---------------------------------------------------------------------------
class VlmLM(StackedLM):
    """The reference's ``VlmLM``: dense blocks with M-RoPE (``pos3``
    [B, S, 3] reaches every block's ``attn_qkv``), and precomputed patch
    embeddings ``patches`` [B, P, d] (the modality frontend is a stub in
    the reference too), projected by ``patch_proj`` [d, d] and added to
    the first P positions, in ``loss_fn``, ``hidden_states_fn`` and every
    prefill. Decode has no patches."""

    def param_specs(self) -> Dict[str, Any]:
        specs = super().param_specs()
        specs["patch_proj"] = ParamSpec((self.cfg.d_model, self.cfg.d_model),
                                        axes=("embed", None))
        return specs

    def _fuse_frontend(self, params, x, batch):
        patches = batch.get("patches")
        if patches is None:
            return x
        p = torch.einsum("bpd,de->bpe", patches.to(x.dtype),
                         params["patch_proj"])
        P = p.shape[1]
        return torch.cat([x[:, :P] + p, x[:, P:]], dim=1)


def build_vlm(cfg: ArchConfig, remat: bool = True,
              cache_quant: bool = False) -> VlmLM:
    return VlmLM(cfg, [_attn_segment(cfg, "blocks", cfg.num_layers,
                                     cache_quant)],
                 remat, cache_quant,
                 paged_ok=not (cache_quant or cfg.sliding_window))
