"""Device selection for the port's entry points, and host arrays onto the
device.

The port is written for one NVIDIA GPU. Entry points default to ``cuda``
and use the CPU only when the caller asks for it (the CPU tests do); with
no card and no explicit CPU request they raise instead of quietly running
somewhere else.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises.
    ``meta`` (tensors with shapes and types and no memory) is taken only
    when asked for by name: the dry-run and the cost counts run on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch reference path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a, device: torch.device, dtype=np.int64) -> torch.Tensor:
    """A host array as a tensor on ``device``. On a card the copy goes
    through pinned memory and does not block: a copy from pageable memory
    would synchronise the host with the stream, and could not feed a
    captured graph's input buffer without that wait. The pinned block is
    the caching host allocator's, which reuses it only once the copy has
    run."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
