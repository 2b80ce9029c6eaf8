"""Config registry of the port: ``get_arch(name)``, ``reduced``."""
from __future__ import annotations

from .base import DENSE, MOE, ArchConfig, reduced
from .command_r_35b import CONFIG as _command_r
from .glm4_9b import CONFIG as _glm4
from .llama3_2_1b import CONFIG as _llama1b
from .llama3_2_3b import CONFIG as _llama3b
from .qwen2_moe_a2_7b import CONFIG as _qwen2_moe

# the reference's configs that its engine serves on the paged path and
# StackedLM serves here (RoPE, full attention, one homogeneous segment);
# moonshot-v1-16b-a3b (a dense stem segment, which the reference's engine
# refuses), the VLM, xLSTM, Hymba and Whisper families are ROADMAP queue
# 1, item 9
ARCHS = {c.name: c for c in [_llama1b, _llama3b, _glm4, _command_r,
                             _qwen2_moe]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "DENSE", "MOE", "get_arch", "reduced"]
