"""Architecture configuration for the PyTorch port (dense family).

A copy of the dense subset of ``repro.configs.base``: the port imports
nothing of the JAX package, so it keeps its own ``ArchConfig`` and
``reduced()``. Field names and the shrink rule are the reference's, so a
config built here describes the same model as its JAX counterpart.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

DENSE = "dense"
FAMILIES = (DENSE,)


@dataclass(frozen=True)
class ArchConfig:
    """A dense decoder-only transformer (exact published dims)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
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
        """Parameters of one dense block: attention, MLP, two norms."""
        return self.attn_params() + self.mlp_params() + 2 * self.d_model

    def block_active_params(self, layer_idx: int = 0) -> int:
        """Parameters touched per token (every one, for a dense block)."""
        return self.block_params(layer_idx)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink an arch to CPU-smoke size, as ``repro.configs.base.reduced``
    does for the dense family (GQA grouping preserved where it divides)."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.sliding_window:
        changes.update(sliding_window=32)
    return dataclasses.replace(cfg, **changes)
