"""GLM-4-9B: 40L dense, GQA kv=2, RoPE. [hf:THUDM/glm-4-9b]"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family=DENSE,
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13_696, vocab_size=151_552, head_dim=128,
    pos_type="rope", rope_theta=10_000.0,
)
