"""Llama-3.2-1B: 16L dense, GQA kv=8. [hf:meta-llama/Llama-3.2-1B]"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family=DENSE,
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128_256, head_dim=64,
    pos_type="rope", rope_theta=500_000.0, tie_embeddings=True,
)
