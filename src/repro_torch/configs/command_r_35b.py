"""Command-R 35B: 40L dense, GQA kv=8, no bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family=DENSE,
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22_528, vocab_size=256_000, head_dim=128,
    pos_type="rope", rope_theta=8_000_000.0, use_bias=False,
    tie_embeddings=True,
)
