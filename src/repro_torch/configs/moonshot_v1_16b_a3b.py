"""Moonlight / moonshot-v1-16B-A3B: 48L MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B]. DeepSeek-V3-style: first block dense.
"""
from .base import ArchConfig, MOE

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family=MOE,
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163_840, head_dim=128,
    num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
    first_k_dense=1, moe_d_ff=1408, dense_stem_d_ff=11_264,
    pos_type="rope", rope_theta=50_000.0,
    notes=("assignment dims are authoritative: 48L (released Moonlight uses 27L, "
           "hence '16B-A3B'); with 48L this config is 28.4B total / 4.8B active"),
)
