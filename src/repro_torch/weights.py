"""Carry a parameter tree (any family's: the segments ``stem`` and
``blocks``, a VLM's ``patch_proj``, Hymba's ``ssm`` leaves with the
depthwise ``conv_w`` in the reference's ``[k, di]`` layout, xLSTM's
``pairs`` with their ``slstm`` and ``mlstm`` subtrees, Whisper's ``enc``
and ``dec`` stacks), an optimizer state, a timeline cache or a
``TinyCNN``'s kernels across from the JAX package.

The port keeps the reference's parameter tree and layouts, so conversion
is a leaf-by-leaf copy. JAX bf16 leaves come out of ``np.asarray`` as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses; they travel
as their raw 16-bit patterns instead.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(arr: Any) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` accepts) -> a CPU tensor
    with the same bits; bfloat16 goes through int16."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Any, device: Optional[Union[str, torch.device]]
                    = None, dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of arrays (the JAX package's params as numpy) -> the
    same tree of tensors on ``device`` (default ``cuda``). Floating leaves
    are cast to ``dtype`` when one is given."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = tensor_from_numpy(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def opt_state_from_jax(state: Any, device: Optional[Union[str, torch.device]]
                       = None):
    """The JAX package's ``AdamWState(master, m, v)`` (each a tree of
    arrays) -> the port's ``AdamWState`` of tensors on ``device``, bits
    unchanged."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(*(params_from_jax(getattr(state, f), device)
                        for f in AdamWState._fields))


def cache_from_jax(cache: Any, device: Optional[Union[str, torch.device]]
                   = None) -> Any:
    """The JAX package's timeline cache (as numpy: each segment's body,
    ``(k, v)``, ``(k_q8, v_q8, k_s, v_s)``, Hymba's ``((k, v), (conv,
    ssm))`` or xLSTM's ``"pairs"`` state ``((h, c, n, m), (C, n, m))``,
    or Whisper's ``"kv"`` and ``"xkv"`` pairs, beside ``"len"`` and an
    optional ``"start"``) -> the port's cache dict of tensors on
    ``device`` (default ``cuda``), bits unchanged: ``len`` a 0-d int32
    tensor, ``start`` [B] int32, each body a tree of tuples, so
    ``decode_fn`` can run from one state in both packages."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, (tuple, list)):
            return tuple(conv(a) for a in x)
        return tensor_from_numpy(x).to(dev)

    return {k: conv(v) for k, v in cache.items()}


def cnn_from_jax(kernels: Any, device: Optional[Union[str, torch.device]]
                 = None) -> list:
    """The reference's ``TinyCNN.kernels`` (HWIO ``[3, 3, in, out]`` arrays)
    -> the port's OIHW ``[out, in, 3, 3]`` tensors on ``device`` (default
    ``cuda``), values unchanged: ``TinyCNN(table, kernels=...)`` then
    computes what the reference's computes."""
    dev = resolve_device(device)
    return [tensor_from_numpy(w).permute(3, 2, 0, 1).contiguous().to(dev)
            for w in kernels]
