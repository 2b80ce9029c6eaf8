"""Analytic FLOP / HBM-byte models per (arch x shape).

XLA's ``HloCostAnalysis`` counts each ``while`` body ONCE (scan bodies are
not multiplied by trip count), so compiled cost_analysis massively
under-reports for scan-over-layers programs. The roofline therefore uses
these documented analytic models for compute/memory terms; collective bytes
come from the HLO call-graph walk (hlo_analysis.walk_collectives) which
*does* multiply by trip counts. EXPERIMENTS.md §Roofline records the
convention.

Formulas (bf16 compute, f32 optimizer):
  matmul flops        = 2 * tokens * active_params(block)
  attention flops     = 4 * B * H * hd * S * ctx_eff   (qk + pv, causal 1/2)
  train multiplier    = 4x fwd for scanned blocks (fwd + remat-refwd + 2 bwd),
                        3x for embed/head (no remat)
  train HBM/param     = 36 B  (3 param reads bf16, grad r/w bf16,
                        master+m+v read/write f32, param write bf16)
  activation traffic  = 2 * L * B * S * d * 2B  (block-boundary saves + reads)
  decode HBM          = active params (2B) + full KV cache read + write slice

The port's copy of ``repro/utils/analytic_cost.py``, on
``repro_torch.configs``. The HYBRID branch (hymba-1.5b: SSM state and
conv window beside the rolling KV) reads ``ssm_state`` and
``conv_kernel``; the SSM and ENCDEC branches are kept as the reference's,
and no registered port config reaches them yet (xLSTM, Whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig, SSM, HYBRID, ENCDEC

BF16 = 2
F32 = 4


def _attn_ctx(cfg: ArchConfig, S: int) -> float:
    """Effective context per query for training/prefill (causal avg S/2,
    sliding window caps it)."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, S / 2)
    if cfg.family == SSM:
        return 0.0                     # recurrent, no quadratic term
    return S / 2


def _block_attn_flops(cfg: ArchConfig, B: int, S: int, ctx: float) -> float:
    return 4.0 * B * cfg.num_heads * cfg.head_dim * S * ctx


def _ssm_extra_flops(cfg: ArchConfig, tokens: int) -> float:
    """mLSTM outer products / selective-scan state updates."""
    if cfg.family == SSM:
        return 6.0 * tokens * cfg.num_heads * cfg.head_dim ** 2
    if cfg.family == HYBRID:
        return 6.0 * tokens * cfg.d_model * cfg.ssm_state
    return 0.0


@dataclasses.dataclass
class CostEstimate:
    flops: float
    hbm_bytes: float
    model_flops: float                 # 6*N*D train / 2*N*D inference

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)


def estimate(cfg: ArchConfig, shape: ShapeConfig, *, cache_bytes: int = 2,
             state_bytes: int = 4) -> CostEstimate:
    B, S = shape.global_batch, shape.seq_len
    N_active = cfg.total_active_params()
    N_total = cfg.total_params()
    embed_params = cfg.embed_params()
    body_active = N_active - embed_params
    d = cfg.d_model

    if shape.kind == "train":
        tokens = B * S
        fwd_blocks = 2.0 * tokens * body_active + cfg.num_layers * \
            _block_attn_flops(cfg, B, S, _attn_ctx(cfg, S)) + \
            _ssm_extra_flops(cfg, tokens)
        if cfg.family == ENCDEC:
            enc_tokens = B * cfg.encoder_seq
            fwd_blocks += cfg.encoder_layers * _block_attn_flops(
                cfg, B, cfg.encoder_seq, cfg.encoder_seq / 2)
        fwd_embed = 2.0 * tokens * embed_params / (2 if cfg.tie_embeddings else 1)
        flops = 4.0 * fwd_blocks + 3.0 * fwd_embed * (2 if cfg.tie_embeddings else 1)
        hbm = N_total * 36.0 + 2.0 * cfg.num_layers * tokens * d * BF16 \
            + 2.0 * tokens * d * BF16
        model_flops = 6.0 * N_active * tokens
        return CostEstimate(flops, hbm, model_flops)

    if shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * tokens * N_active + cfg.num_layers * \
            _block_attn_flops(cfg, B, S, _attn_ctx(cfg, S)) + \
            _ssm_extra_flops(cfg, tokens)
        cb = _kv_cache_bytes(cfg, B, S, cache_bytes, state_bytes)
        hbm = N_total * BF16 + 2.0 * cfg.num_layers * tokens * d * BF16 \
            + cb
        return CostEstimate(flops, hbm, 2.0 * N_active * tokens)

    # decode: one token per sequence against a seq_len cache
    tokens = B
    ctx = min(cfg.sliding_window, S) if cfg.sliding_window else S
    if cfg.family == SSM:
        attn = _ssm_extra_flops(cfg, tokens) * cfg.num_layers / 2
    else:
        attn = cfg.num_layers * 4.0 * B * cfg.num_heads * cfg.head_dim * ctx
        attn += _ssm_extra_flops(cfg, tokens)
    flops = 2.0 * tokens * N_active + attn
    cb = _kv_cache_bytes(cfg, B, S, cache_bytes, state_bytes)
    hbm = N_total * BF16 + cb  # read params + read cache (+eps write)
    return CostEstimate(flops, hbm, 2.0 * N_active * tokens)


def _kv_cache_bytes(cfg: ArchConfig, B: int, S: int, cache_bytes: int = 2,
                    state_bytes: int = 4) -> float:
    if cfg.family == SSM:
        pairs = cfg.num_layers // 2
        m = B * cfg.num_heads * cfg.head_dim * (cfg.head_dim + 2) * state_bytes
        s = 4 * B * cfg.num_heads * cfg.head_dim * state_bytes
        return pairs * (m + s)
    ctx = min(cfg.sliding_window, S) if cfg.sliding_window else S
    kv = 2.0 * cfg.num_layers * B * cfg.num_kv_heads * ctx * cfg.head_dim * cache_bytes
    if cfg.family == HYBRID:
        kv += cfg.num_layers * B * cfg.d_model * (cfg.ssm_state * F32 +
                                                  (cfg.conv_kernel - 1) * BF16)
    if cfg.family == ENCDEC:
        kv += 2.0 * cfg.num_layers * B * cfg.num_kv_heads * cfg.encoder_seq \
            * cfg.head_dim * BF16
    return kv
