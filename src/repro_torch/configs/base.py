"""Architecture configuration for the PyTorch port (dense family).

A copy of the dense subset of ``repro.configs.base``: the port imports
nothing of the JAX package, so it keeps its own ``ArchConfig`` and
``reduced()``. Field names and the shrink rule are the reference's, so a
config built here describes the same model as its JAX counterpart.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

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
