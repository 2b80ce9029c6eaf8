"""The train step of the port (``repro/runtime/steps.py::make_train_step``)
on one device, with no mesh.

The reference's sharding trees (``param_shardings``, ``opt_shardings``,
``batch_shardings``), its serve steps and ``abstract_inputs`` need a mesh
and come with it (ROADMAP queue 1, item 12); the compressed cross-pod
step comes with multi-card placement (item 10).

On the card the step runs under ``torch.use_deterministic_algorithms``,
so a run repeats its bits and a resumed run ends where a straight one
does: the embedding's backward (an index with accumulate) and the loss's
gather backward take their sorted, atomic-free forms. That mode needs
``CUBLAS_WORKSPACE_CONFIG`` in the environment before cuBLAS starts; the
launcher sets it first thing, and ``make_train_step`` sets it if no one
has.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.models.api import ModelAPI
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, map_tree

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic(enabled: bool):
    """``torch.use_deterministic_algorithms(True)`` inside, the previous
    setting restored after. Uninitialised memory is not filled: every
    buffer the step allocates is written before it is read."""
    if not enabled:
        yield
        return
    import torch.utils.deterministic as det
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def batch_to_device(batch: Dict[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Host arrays (numpy) onto ``device`` in their own dtypes, through
    pinned memory on a card so the copy does not wait for queued work."""
    return {k: to_device(v, device, np.asarray(v).dtype)
            for k, v in batch.items()}


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, shape: ShapeConfig,
                    *, device: Optional[Union[str, torch.device]] = None):
    """``train_step(params, opt_state, batch, step) -> (loss, params,
    opt_state, gnorm)``: the loss and its gradient by autograd, then
    ``adamw.update``. ``params`` and ``opt_state`` are updated in place
    (the reference donates them) and returned; ``loss`` and ``gnorm`` are
    0-d f32 tensors on the device, not read back. ``batch`` holds host
    arrays ``tokens`` and ``labels`` [global_batch, seq_len]. ``device``
    defaults to ``cuda`` and must be the model's."""
    dev = resolve_device(device)
    if dev != api.device:
        raise ValueError(f"make_train_step: device {dev} but the model is "
                         f"on {api.device}")
    on_card = dev.type == "cuda"
    if on_card:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    want = (shape.global_batch, shape.seq_len)

    def train_step(params, opt_state, batch, step):
        if tuple(np.shape(batch["tokens"])) != want:
            raise ValueError(f"train_step: tokens {np.shape(batch['tokens'])}"
                             f" but the step's shape is {want}")
        b = batch_to_device(batch, dev)
        step_t = to_device(np.asarray(step, np.float32), dev,
                           np.float32).reshape(())
        with deterministic(on_card):
            tracked = map_tree(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                loss = api.loss_fn(tracked, b)
                flat = torch.autograd.grad(loss, leaves(tracked))
            it = iter(flat)
            grads = map_tree(lambda _: next(it), tracked)
            del tracked
            params, opt_state, gnorm = adamw.update(opt_cfg, grads,
                                                    opt_state, step_t,
                                                    params=params)
        return loss.detach(), params, opt_state, gnorm

    return train_step
