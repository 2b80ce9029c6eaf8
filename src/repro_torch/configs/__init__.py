"""Config registry of the port: ``get_arch(name)``, ``reduced``."""
from __future__ import annotations

from .base import DENSE, ArchConfig, reduced
from .command_r_35b import CONFIG as _command_r
from .glm4_9b import CONFIG as _glm4
from .llama3_2_1b import CONFIG as _llama1b
from .llama3_2_3b import CONFIG as _llama3b

# the reference's dense configs that StackedLM serves (RoPE, full
# attention, no bias); the other families are ROADMAP queue 1, item 8
ARCHS = {c.name: c for c in [_llama1b, _llama3b, _glm4, _command_r]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "DENSE", "get_arch", "reduced"]
