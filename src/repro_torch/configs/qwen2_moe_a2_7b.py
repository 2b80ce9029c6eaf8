"""Qwen1.5-MoE-A2.7B: 24L, 60 routed experts top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from .base import MOE, ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family=MOE,
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151_936, head_dim=128,
    num_experts=60, num_experts_per_tok=4, num_shared_experts=4,
    moe_d_ff=1408, pos_type="rope", rope_theta=1_000_000.0,
    use_bias=True,
    notes="4 shared + 60 routed top-4",
)
