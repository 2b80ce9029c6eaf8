"""Config registry of the port: ``get_arch(name)``, ``reduced``."""
from __future__ import annotations

from .base import DENSE, ArchConfig, reduced
from .llama3_2_1b import CONFIG as _llama1b

ARCHS = {c.name: c for c in [_llama1b]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "DENSE", "get_arch", "reduced"]
