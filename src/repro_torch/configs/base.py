"""Architecture configuration for the PyTorch port (dense and MoE families).

A copy of the dense and MoE subset of ``repro.configs.base``: the port
imports nothing of the JAX package, so it keeps its own ``ArchConfig``
and ``reduced()``. Field names, parameter counts and the shrink rule are
the reference's, so a config built here describes the same model as its
JAX counterpart and the planner places it the same way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

DENSE = "dense"
MOE = "moe"
FAMILIES = (DENSE, MOE)


@dataclass(frozen=True)
class ArchConfig:
    """A decoder-only transformer, dense or MoE (exact published dims)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0              # leading dense blocks (DeepSeek-style)
    moe_d_ff: int = 0                   # expert hidden dim (0 -> d_ff)
    dense_stem_d_ff: int = 0            # hidden dim of the dense stem blocks

    sliding_window: int = 0             # 0 = full attention
    pos_type: str = "rope"
    rope_theta: float = 10_000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    notes: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} is not ported yet "
                             f"(ported: {FAMILIES})")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.family == MOE and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    # --- parameter counting (read by the planner's cost model) -----------
    def attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def mlp_params(self, d_ff: Optional[int] = None) -> int:
        dff = self.d_ff if d_ff is None else d_ff
        return 3 * self.d_model * dff  # gated (SwiGLU-style): up, gate, down

    def block_params(self, layer_idx: int = 0) -> int:
        """Parameters of one block: attention, MLP or router and experts,
        two norms."""
        d = self.d_model
        norms = 2 * d
        if self.family == MOE:
            if layer_idx < self.first_k_dense:
                return (self.attn_params()
                        + self.mlp_params(self.dense_stem_d_ff or self.d_ff)
                        + norms)
            router = d * self.num_experts
            experts = self.num_experts * 3 * d * self.moe_d_ff
            shared = self.num_shared_experts * 3 * d * self.moe_d_ff
            return self.attn_params() + router + experts + shared + norms
        return self.attn_params() + self.mlp_params() + norms

    def block_active_params(self, layer_idx: int = 0) -> int:
        """Parameters touched per token (MoE: only routed-to experts)."""
        if self.family == MOE and layer_idx >= self.first_k_dense:
            d = self.d_model
            router = d * self.num_experts
            active = ((self.num_experts_per_tok + self.num_shared_experts)
                      * 3 * d * self.moe_d_ff)
            return self.attn_params() + router + active + 2 * d
        return self.block_params(layer_idx)

    def embed_params(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n *= 2  # separate LM head
        return n

    def total_params(self) -> int:
        blocks = sum(self.block_params(i) for i in range(self.num_layers))
        return blocks + self.embed_params() + self.d_model

    def total_active_params(self) -> int:
        blocks = sum(self.block_active_params(i)
                     for i in range(self.num_layers))
        return blocks + self.embed_params() + self.d_model


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink an arch to CPU-smoke size, as ``repro.configs.base.reduced``
    does for the dense and MoE families (GQA grouping preserved where it
    divides; MoE keeps routing, top-k and shared experts at 8 experts)."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 4 if cfg.family != MOE else 3),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.is_moe:
        changes.update(num_experts=8,
                       num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                       num_shared_experts=min(1, cfg.num_shared_experts),
                       moe_d_ff=64, first_k_dense=min(1, cfg.first_k_dense),
                       dense_stem_d_ff=128 if cfg.first_k_dense else 0)
    if cfg.sliding_window:
        changes.update(sliding_window=32)
    return dataclasses.replace(cfg, **changes)
