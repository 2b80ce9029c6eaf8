"""Decoder stack of the port (the dense family of
``repro/models/transformer.py`` and the MoE family's blocks of
``repro/models/moe.py``, one homogeneous segment).

Parameters are a plain dict with the reference's tree and layouts: block
weights stacked along a leading layer dim under ``"blocks"`` (``wq``
``[L, d, H, hd]``, ``wo [L, H, hd, d]``, an MoE block's ``moe.wi``
``[L, E, d, dff]``, ...), tied embeddings for llama.
A parameter tree converted from the JAX package (``repro_torch.weights``)
therefore drops in as is. The block loop is a Python loop over layers
(the reference's ``lax.scan``); the paged KV pools are per-segment
``(k, v)`` tensors ``[L, N, KVH, page_size, D]`` updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from . import layers as L
from .layers import ParamSpec, init_one
from .moe import moe_block_specs, moe_mlp_apply

SEGMENT = "blocks"          # the reference's name for the served segment


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


def dense_block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln1": ParamSpec((d,), "ones"),
        "ln2": ParamSpec((d,), "ones"),
        "attn": L.attn_specs(cfg),
        "mlp": {
            "wi": ParamSpec((d, ff)),
            "wg": ParamSpec((d, ff)),
            "wo": ParamSpec((ff, d)),
        },
    }


def _map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def _at(tree, l: int):
    """Layer ``l`` of a tree of stacked block weights."""
    if isinstance(tree, dict):
        return {k: _at(v, l) for k, v in tree.items()}
    return tree[l]


class StackedLM:
    """A causal LM: embedding, ``num_layers`` pre-norm blocks (dense, or
    MoE: dense attention and an MoE FFN), final norm, tied (or separate)
    output head."""

    def __init__(self, cfg: ArchConfig):
        if cfg.sliding_window or cfg.pos_type != "rope":
            raise NotImplementedError(
                f"{cfg.name}: sliding windows and non-RoPE positions are "
                f"not ported yet (ROADMAP queue 1, item 9)")
        if cfg.first_k_dense:
            raise NotImplementedError(
                f"{cfg.name}: a dense stem segment ahead of the MoE blocks "
                f"is not served; the reference's engine also serves only "
                f"a single homogeneous segment")
        self.cfg = cfg

    # -- parameters --------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        c = self.cfg
        specs: Dict[str, Any] = {
            "embed": ParamSpec((c.vocab_size, c.d_model), "embed"),
            "ln_f": ParamSpec((c.d_model,), "ones"),
        }
        if not c.tie_embeddings:
            specs["head"] = ParamSpec((c.d_model, c.vocab_size))
        block = moe_block_specs(c) if c.is_moe else dense_block_specs(c)
        specs[SEGMENT] = _map_specs(
            lambda s: ParamSpec((c.num_layers,) + s.shape, s.init, s.scale),
            block)
        return specs

    def init_params(self, generator: torch.Generator, device, dtype):
        return _map_specs(lambda s: init_one(s, generator, device, dtype),
                          self.param_specs())

    # -- embedding / head --------------------------------------------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """h [B, d] -> f32 logits [B, V]. The reference asks XLA for f32
        accumulation over its bf16 operands (``preferred_element_type``);
        upcasting the operands is exact, so the head runs in f32."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return h.float() @ w.float()

    @staticmethod
    def _layer(params, l: int) -> Dict[str, Any]:
        return _at(params[SEGMENT], l)

    def _mlp(self, p, x):
        h = L.rmsnorm(x, p["ln2"], self.cfg.norm_eps)
        if "moe" in p:
            # inference dispatches without capacity dropping, as the
            # reference's moe_block_apply does outside training
            out, _ = moe_mlp_apply(self.cfg, p["moe"], h, drop_tokens=False,
                                   aux=False)
            return x + out
        m = p["mlp"]
        return x + L.swiglu(h, m["wi"], m["wg"], m["wo"])

    # -- public: batched right-padded prefill --------------------------------
    def _prefill(self, params, tokens: torch.Tensor):
        """Every block over right-padded prompts ``tokens`` [B, S], causal
        attention through ``L.chunked_attention`` (the flash kernel on the
        card). Returns (x [B, S, d] after the final norm, {"blocks": (k, v)}
        with k, v [L, B, KVH, S, D])."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :]
        x = self.embed(params, tokens)
        ks, vs = [], []
        for l in range(cfg.num_layers):
            p = self._layer(params, l)
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
            ctx = L.chunked_attention(q, k, v, causal=True)
            x = x + L.attn_out(p["attn"], ctx)
            x = self._mlp(p, x)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return x, {SEGMENT: (torch.stack(ks), torch.stack(vs))}

    def prefill_at_fn(self, params, batch):
        """Whole-prompt prefill for paged admission: ``tokens`` [B, S_pad]
        right-padded, ``prompt_len`` the true length (a host int, or an
        int64 tensor of one element on the tokens' device, as the engine
        passes it so that a CUDA graph per bucket serves every length).
        Causal attention hides the padding; logits are read at
        ``prompt_len - 1``. Returns (logits [B, V] f32, {"blocks": (k, v)})
        with k, v [L, B, KVH, S_pad, D] — only the first ``prompt_len``
        positions are meaningful."""
        tokens = batch["tokens"]
        x, caches = self._prefill(params, tokens)
        last = _last_positions(batch["prompt_len"], tokens.device)
        return self.logits(params, x.index_select(1, last)[:, 0]), caches

    def prefill_packed_fn(self, params, batch):
        """``prefill_at_fn`` over K prompts at once: ``tokens`` [K, S_pad]
        holds K right-padded prompts, ``prompt_lens`` their true lengths
        (K host ints, or an int64 [K] tensor on the tokens' device). Rows
        never attend to each other and causal attention hides each row's
        padding, so row b's logits — read at its own ``prompt_lens[b] - 1``
        — and cache positions < ``prompt_lens[b]`` are those of a solo
        ``prefill_at_fn`` call at the same bucket."""
        tokens = batch["tokens"]
        K, S = tokens.shape
        x, caches = self._prefill(params, tokens)
        rows = torch.arange(K, device=tokens.device) * S
        last = rows + _last_positions(batch["prompt_lens"], tokens.device)
        return self.logits(params, x.flatten(0, 1).index_select(0, last)), \
            caches

    # -- public: chunked prefill (resume at an offset, pools carried in) -----
    def prefill_chunk_fn(self, params, pools, batch):
        """One prefill chunk against the paged cache: ``tokens`` [1, C] is
        chunk [offset, offset + chunk_len) of a prompt, right-padded to the
        engine's chunk size C; ``pools`` ``{"blocks": (k, v)}`` the
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
        logits [1, V] at the chunk's last valid token, the same pools)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        C = tokens.shape[1]
        offset = int(batch["offset"])
        positions = offset + torch.arange(C, device=tokens.device)[None, :]
        k_pool, v_pool = pools[SEGMENT]
        bt = batch["bt_row"]
        targets = L.chunk_write_targets(
            _as_index(batch["pages"], tokens.device),
            _as_index(batch["offs"], tokens.device), k_pool.shape[1])
        x = self.embed(params, tokens)
        for l in range(cfg.num_layers):
            p = self._layer(params, l)
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
            ctx = L.chunk_prefill_attention(q, k, v, k_pool[l], v_pool[l], bt,
                                            offset)
            L.paged_write_chunk(k_pool[l], v_pool[l], k[0], v[0], targets)
            x = x + L.attn_out(p["attn"], ctx)
            x = self._mlp(p, x)
        x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
        last = _last_positions(batch["chunk_len"], tokens.device)
        return self.logits(params, x.index_select(1, last)[:, 0]), pools

    # -- public: paged decode ------------------------------------------------
    def decode_blocks(self, params, pools, x: torch.Tensor,
                      block_tables: torch.Tensor, seq_lens: torch.Tensor,
                      start: int = 0, end: Optional[int] = None
                      ) -> torch.Tensor:
        """Blocks ``[start, end)`` of one paged decode step for the rows of
        ``block_tables`` [B, MP] / ``seq_lens`` [B] (positions are the
        per-row ``seq_lens``, 0-based). ``x`` [B, 1, d] is the residual
        stream entering block ``start``; returns the one leaving block
        ``end - 1``. Each block writes its new K/V into its own layer of the
        pools ``(k, v)`` [L, N, KVH, Pg, D] in place and attends over
        ``seq_lens + 1`` tokens. ``decode_paged_fn`` runs every block; a
        pipeline stage runs its own range on its microbatch's rows."""
        cfg = self.cfg
        end = cfg.num_layers if end is None else end
        positions = seq_lens[:, None]
        sl_next = seq_lens + 1
        k_pool, v_pool = pools
        for l in range(start, end):
            p = self._layer(params, l)
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
            L.paged_write(k_pool[l], v_pool[l], k[:, 0], v[:, 0],
                          block_tables, seq_lens)
            ctx = L.paged_decode_attention(q, k_pool[l], v_pool[l],
                                           block_tables, sl_next)
            x = x + L.attn_out(p["attn"], ctx)
            x = self._mlp(p, x)
        return x

    def head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and output head at the last position: x [B, S, d] ->
        f32 logits [B, V]."""
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return self.logits(params, x[:, -1])

    def decode_paged_fn(self, params, cache, batch):
        """One decode step over the paged cache. ``cache`` holds the pools
        ``{"blocks": (k, v)}`` ``[L, N, KVH, Pg, D]``, ``block_tables``
        [B, MP] and ``seq_lens`` [B] (int32). Positions are per-row and
        0-based. The pools and ``seq_lens`` are updated in place (rows that
        hold a sequence advance by one; idle rows stay 0) and the same
        cache dict is returned with the f32 logits."""
        bt, sl = cache["block_tables"], cache["seq_lens"]
        x = self.embed(params, batch["tokens"])          # [B, 1, d]
        x = self.decode_blocks(params, cache[SEGMENT], x, bt, sl)
        logits = self.head(params, x)
        sl.copy_(torch.where(sl > 0, sl + 1, sl))
        return logits, cache

    # -- caches --------------------------------------------------------------
    def init_paged_cache_specs(self, num_slots: int, num_pages: int,
                               page_size: int, pages_per_slot: int,
                               dtype) -> Dict[str, Any]:
        """Shapes and types of the paged cache: per-segment page pools
        (stacked layer dim), one block table [num_slots, pages_per_slot]
        and per-slot seq_lens. Page 0 is the reserved null page."""
        c = self.cfg
        pool = ((c.num_layers, num_pages, c.num_kv_heads, page_size,
                 c.head_dim), dtype)
        return {SEGMENT: (pool, pool),
                "block_tables": ((num_slots, pages_per_slot), torch.int32),
                "seq_lens": ((num_slots,), torch.int32)}

