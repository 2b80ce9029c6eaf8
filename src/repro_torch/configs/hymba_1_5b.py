"""Hymba-1.5B: 32L hybrid heads (parallel attention + mamba), SWA. [arXiv:2411.13676]

Sub-quadratic decode: SSM state + sliding-window KV -> runs long_500k.
"""
from .base import ArchConfig, HYBRID

CONFIG = ArchConfig(
    name="hymba-1.5b", family=HYBRID,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32_001, head_dim=64,
    ssm_state=16, sliding_window=2048,
    pos_type="rope", rope_theta=10_000.0,
    notes="parallel attn+SSM heads fused per block; SWA=2048 (global-attn layers folded into SWA for uniform stack, see DESIGN)",
)
