"""Dense decoder stack of the port (dense subset of
``repro/models/transformer.py``).

Parameters are a plain dict with the reference's tree and layouts: block
weights stacked along a leading layer dim under ``"blocks"`` (``wq``
``[L, d, H, hd]``, ``wo [L, H, hd, d]``, ...), tied embeddings for llama.
A parameter tree converted from the JAX package (``repro_torch.weights``)
therefore drops in as is. The block loop is a Python loop over layers
(the reference's ``lax.scan``); the paged KV pools are per-segment
``(k, v)`` tensors ``[L, N, KVH, page_size, D]`` updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from . import layers as L

SEGMENT = "blocks"          # the reference's single dense segment name


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"    # normal | ones | embed


def dense_block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, KVH, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    return {
        "ln1": ParamSpec((d,), "ones"),
        "ln2": ParamSpec((d,), "ones"),
        "attn": {
            "wq": ParamSpec((d, H, hd)),
            "wk": ParamSpec((d, KVH, hd)),
            "wv": ParamSpec((d, KVH, hd)),
            "wo": ParamSpec((H, hd, d)),
        },
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


def init_one(spec: ParamSpec, generator: torch.Generator, device,
             dtype) -> torch.Tensor:
    """The reference's initializer (``repro.models.layers._init_one``):
    ones, N(0, 0.02) for the embedding, else N(0, 1 / sqrt(fan_in))
    with fan_in = the spec's leading dim. For stacked block weights that
    leading dim is the layer count, as in the reference, so random-weight
    runs of the two packages sit in the same numeric range. Draws in f32
    from ``generator`` (on ``device``), then casts."""
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device, dtype=dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    std = 0.02 if spec.init == "embed" else 1.0 / math.sqrt(fan_in)
    w = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


class StackedLM:
    """A dense causal LM: embedding, ``num_layers`` pre-norm blocks, final
    norm, tied (or separate) output head."""

    def __init__(self, cfg: ArchConfig):
        if cfg.sliding_window or cfg.use_bias or cfg.pos_type != "rope":
            raise NotImplementedError(
                f"{cfg.name}: sliding windows, attention biases and "
                f"non-RoPE positions are not ported yet (ROADMAP queue 1, "
                f"item 10)")
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
        specs[SEGMENT] = _map_specs(
            lambda s: ParamSpec((c.num_layers,) + s.shape, s.init),
            dense_block_specs(c))
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
        blk = params[SEGMENT]
        return {"ln1": blk["ln1"][l], "ln2": blk["ln2"][l],
                "attn": {k: v[l] for k, v in blk["attn"].items()},
                "mlp": {k: v[l] for k, v in blk["mlp"].items()}}

    def _mlp(self, p, x):
        h = L.rmsnorm(x, p["ln2"], self.cfg.norm_eps)
        m = p["mlp"]
        return x + L.swiglu(h, m["wi"], m["wg"], m["wo"])

    # -- public: batched right-padded prefill --------------------------------
    def prefill_at_fn(self, params, batch):
        """Whole-prompt prefill for paged admission: ``tokens`` [B, S_pad]
        right-padded, ``prompt_len`` the true length (an int). Causal
        attention hides the padding; logits are read at ``prompt_len - 1``.
        Returns (logits [B, V] f32, {"blocks": (k, v)}) with k, v
        [L, B, KVH, S_pad, D] — only the first ``prompt_len`` positions are
        meaningful."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :]
        x = self.embed(params, tokens)
        ks, vs = [], []
        for l in range(cfg.num_layers):
            p = self._layer(params, l)
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
            ctx = L.causal_attention(q, k, v)
            x = x + L.attn_out(p["attn"], ctx)
            x = self._mlp(p, x)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self.logits(params, x[:, int(batch["prompt_len"]) - 1])
        return logits, {SEGMENT: (torch.stack(ks), torch.stack(vs))}

    # -- public: paged decode ------------------------------------------------
    def decode_paged_fn(self, params, cache, batch):
        """One decode step over the paged cache. ``cache`` holds the pools
        ``{"blocks": (k, v)}`` ``[L, N, KVH, Pg, D]``, ``block_tables``
        [B, MP] and ``seq_lens`` [B] (int32). Positions are per-row and
        0-based. The pools and ``seq_lens`` are updated in place (rows that
        hold a sequence advance by one; idle rows stay 0) and the same
        cache dict is returned with the f32 logits."""
        cfg = self.cfg
        tokens = batch["tokens"]                      # [B, 1]
        bt, sl = cache["block_tables"], cache["seq_lens"]
        positions = sl[:, None]
        k_pool, v_pool = cache[SEGMENT]
        x = self.embed(params, tokens)
        sl_next = sl + 1
        for l in range(cfg.num_layers):
            p = self._layer(params, l)
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
            L.paged_write(k_pool[l], v_pool[l], k[:, 0], v[:, 0], bt, sl)
            ctx = L.paged_decode_attention(q, k_pool[l], v_pool[l], bt,
                                           sl_next)
            x = x + L.attn_out(p["attn"], ctx)
            x = self._mlp(p, x)
        x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self.logits(params, x[:, -1])
        sl.copy_(torch.where(sl > 0, sl_next, sl))
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

