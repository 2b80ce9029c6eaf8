"""PyTorch/CUDA port of the Serdab serving system (``repro``).

The JAX package ``repro`` is the reference; this package keeps its module
paths and public names, imports ``torch`` and numpy only, and runs its
decode-attention and page-cipher kernels as hand-written CUDA for Hopper
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
