"""xLSTM-125M: 12 blocks, alternating sLSTM/mLSTM, d=768. [arXiv:2405.04517]

Sub-quadratic: decode state is O(1) in context length -> runs long_500k.
"""
from .base import ArchConfig, SSM

CONFIG = ArchConfig(
    name="xlstm-125m", family=SSM,
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50_304, head_dim=192,
    slstm_every=2,  # blocks 0,2,4,... are sLSTM; odd blocks mLSTM
    pos_type="none",
    notes="recurrent state replaces KV cache; d_ff=0 (projections inside block)",
)
