"""Architecture configuration for the PyTorch port (every family the
reference builds: dense, MoE, xLSTM, hybrid, Whisper and the VLM).

A copy of ``repro.configs.base``: the port imports nothing of the JAX
package, so it keeps its own ``ArchConfig`` and ``reduced()``. Every field
of the reference's is here, with its parameter counts and shrink rules,
so a config built here describes the same model as its JAX counterpart,
field for field, and the planner places it the same way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"   # audio backbone (whisper): stub conv frontend
VLM = "vlm"         # vision-language backbone: stub patch frontend
CNN = "cnn"         # the paper's own model family (Serdab evaluation)
FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM, CNN)


@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture (exact published dims)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0              # leading dense blocks (DeepSeek-style)
    moe_d_ff: int = 0                   # expert hidden dim (0 -> d_ff)
    dense_stem_d_ff: int = 0            # hidden dim of the dense stem blocks

    # --- SSM / hybrid ---
    ssm_state: int = 0                  # mamba-style state size
    conv_kernel: int = 4
    sliding_window: int = 0             # 0 = full attention
    slstm_every: int = 0                # xLSTM: every k-th block is sLSTM

    # --- positions ---
    pos_type: str = "rope"              # rope | mrope | learned | none
    rope_theta: float = 10_000.0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                # stub frontend output length

    # --- vlm ---
    num_patches: int = 0                # stub patch-embedding count

    # --- misc ---
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    notes: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.family == MOE and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_subquadratic(self) -> bool:
        """True when decode cost is independent of context length."""
        return self.family in (SSM, HYBRID)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    # --- parameter counting (read by the planner's cost model) -----------
    def attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def mlp_params(self, d_ff: Optional[int] = None) -> int:
        dff = self.d_ff if d_ff is None else d_ff
        return 3 * self.d_model * dff  # gated (SwiGLU-style): up, gate, down

    def block_params(self, layer_idx: int = 0) -> int:
        """Parameters of one block (family aware)."""
        d = self.d_model
        norms = 2 * d
        if self.family == SSM:
            # xLSTM block: qkv+gates projections, ~4x expansion round-trip
            return 8 * d * d + norms
        if self.family == HYBRID:
            ssm = 2 * d * (2 * d) + 2 * d * self.ssm_state * 2 + 2 * d
            return self.attn_params() + ssm + self.mlp_params() + norms
        if self.family == MOE:
            if layer_idx < self.first_k_dense:
                return (self.attn_params()
                        + self.mlp_params(self.dense_stem_d_ff or self.d_ff)
                        + norms)
            router = d * self.num_experts
            experts = self.num_experts * 3 * d * self.moe_d_ff
            shared = self.num_shared_experts * 3 * d * self.moe_d_ff
            return self.attn_params() + router + experts + shared + norms
        return self.attn_params() + self.mlp_params() + norms

    def block_active_params(self, layer_idx: int = 0) -> int:
        """Parameters touched per token (MoE: only routed-to experts)."""
        if self.family == MOE and layer_idx >= self.first_k_dense:
            d = self.d_model
            router = d * self.num_experts
            active = ((self.num_experts_per_tok + self.num_shared_experts)
                      * 3 * d * self.moe_d_ff)
            return self.attn_params() + router + active + 2 * d
        return self.block_params(layer_idx)

    def embed_params(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n *= 2  # separate LM head
        return n

    def _encdec_params(self) -> int:
        """Whisper's encoder blocks (attention + MLP, no cross-attention)
        and its decoder's cross-attention."""
        if self.family != ENCDEC:
            return 0
        enc = self.encoder_layers * (self.attn_params() + self.mlp_params()
                                     + 2 * self.d_model)
        return enc + self.num_layers * self.attn_params()

    def total_params(self) -> int:
        blocks = sum(self.block_params(i) for i in range(self.num_layers))
        return (blocks + self._encdec_params() + self.embed_params()
                + self.d_model)

    def total_active_params(self) -> int:
        blocks = sum(self.block_active_params(i)
                     for i in range(self.num_layers))
        return (blocks + self._encdec_params() + self.embed_params()
                + self.d_model)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink an arch to CPU-smoke size, as ``repro.configs.base.reduced``
    does, preserving family structure (GQA grouping where it divides; MoE
    keeps routing, top-k, shared experts and a one-block dense stem at 8
    experts; SSM state at most 8; a window of 32; 8 patches)."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 4 if cfg.family != MOE else 3),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.is_moe:
        changes.update(num_experts=8,
                       num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                       num_shared_experts=min(1, cfg.num_shared_experts),
                       moe_d_ff=64, first_k_dense=min(1, cfg.first_k_dense),
                       dense_stem_d_ff=128 if cfg.first_k_dense else 0)
    if cfg.family in (SSM, HYBRID):
        changes.update(ssm_state=min(cfg.ssm_state or 8, 8))
    if cfg.sliding_window:
        changes.update(sliding_window=32)
    if cfg.family == ENCDEC:
        changes.update(encoder_layers=2, encoder_seq=24)
    if cfg.family == VLM:
        changes.update(num_patches=8)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    """One step's shape (``repro.configs.base.ShapeConfig``): sequence
    length, global batch and the kind of step."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not when skipped."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % arch.name
    return True, ""
