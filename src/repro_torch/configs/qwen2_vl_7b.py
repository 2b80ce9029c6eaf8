"""Qwen2-VL-7B backbone: 28L dense GQA kv=4, M-RoPE. Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings. [arXiv:2409.12191]
"""
from .base import ArchConfig, VLM

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family=VLM,
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18_944, vocab_size=152_064, head_dim=128,
    num_patches=1024, pos_type="mrope", rope_theta=1_000_000.0,
    use_bias=True,
)
