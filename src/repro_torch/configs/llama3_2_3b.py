"""Llama-3.2-3B: 28L dense, GQA kv=8. [hf:meta-llama/Llama-3.2-3B]"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family=DENSE,
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128_256, head_dim=128,
    pos_type="rope", rope_theta=500_000.0, tie_embeddings=True,
)
