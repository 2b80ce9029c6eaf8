"""Whisper-small backbone: 12L enc + 12L dec, d=768. Conv frontend is a STUB:
input_specs() provides precomputed frame embeddings [B, S_enc, d]. [arXiv:2212.04356]
"""
from .base import ArchConfig, ENCDEC

CONFIG = ArchConfig(
    name="whisper-small", family=ENCDEC,
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51_865, head_dim=64,
    encoder_layers=12, encoder_seq=1500,
    pos_type="learned", use_bias=True,
    notes="enc-dec; decoder cross-attends to 1500-frame encoder memory",
)
