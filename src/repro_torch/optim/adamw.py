"""AdamW with an f32 master copy and f32 moments, a warmup-cosine schedule
and global-norm clipping (the port of ``repro/optim/adamw.py``).

The arithmetic is the reference's, operation for operation in f32:
clipping by ``min(1, clip / max(gnorm, 1e-9))``, moments, bias
corrections ``1 - b ** (step + 1)`` formed on the device from the step
tensor, decay applied as ``lr * wd * master`` inside the step, and new
parameters cast from the master copy to the grads' dtype. Every divisor
is a device tensor: a CUDA tensor divided by a host scalar is multiplied
by its reciprocal, which is not the IEEE quotient XLA computes.

``update`` works in place under ``torch.no_grad()``, where the reference
donates its buffers: at full width a second copy of the master and the
moments would be three times the f32 parameter bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    master: Any          # f32 copy of params
    m: Any
    v: Any


def init(params) -> AdamWState:
    f32 = lambda p: p.detach().to(torch.float32, copy=True)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(map_tree(f32, params), map_tree(zeros, params),
                      map_tree(zeros, params))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _step_tensor(step, device) -> torch.Tensor:
    """The step as an f32 device tensor (a host int, or a tensor the
    caller has already put on the device)."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.float32)
    return _f32(float(step), device)


def schedule(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine down to
    ``min_lr_ratio * lr``; an f32 tensor on ``device`` (the step's device
    when it is a tensor, else the CPU)."""
    if device is None:
        device = step.device if isinstance(step, torch.Tensor) else "cpu"
    step = _step_tensor(step, device)
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), device),
                         _f32(1.0, device))
    prog = torch.clamp((step - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), device), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, leaf_totals: Optional[Callable] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32; the leaves'
    sums are added in leaf order, as the reference's Python ``sum``.
    ``leaf_totals``, where ``tree`` holds a rank's shards of a model split
    over ranks, maps the [n] vector of this rank's per-leaf sums to the
    whole leaves' sums, the same bits on every rank
    (``runtime.steps.ModelShards.leaf_totals``)."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if leaf_totals is not None:
        sums = leaf_totals(torch.stack(sums)).unbind(0)
    total = None
    for s in sums:
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, step,
           params: Optional[Any] = None,
           leaf_totals: Optional[Callable] = None):
    """Returns (new_params, state, gnorm). ``state``'s tensors are updated
    in place and returned. New parameters are the master copy cast to each
    grad's dtype: written into ``params`` in place when it is given (the
    train step's buffers), else fresh tensors. On a rank holding shards,
    ``leaf_totals`` (see ``global_norm``) makes the clipping norm the
    whole model's; the update is elementwise, so a shard's is the whole
    leaf's cut to it."""
    gnorm = global_norm(grads, leaf_totals)
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev), _f32(cfg.clip_norm, dev)
                          / torch.maximum(gnorm, _f32(1e-9, dev)))
    lr = schedule(cfg, step, dev)
    b1, b2 = cfg.b1, cfg.b2
    t = _step_tensor(step, dev) + 1.0
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)

    flat_g = leaves(grads)
    flat_p = leaves(params) if params is not None else [None] * len(flat_g)
    new = []
    for g, master, m, v, p in zip(flat_g, leaves(state.master),
                                  leaves(state.m), leaves(state.v), flat_p):
        g32 = g.float() * scale
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
        # mhat / (sqrt(vhat) + eps) + wd * master, then times lr
        step_dir = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        step_dir.add_(cfg.weight_decay * master).mul_(lr)
        master.sub_(step_dir)
        if p is not None:
            p.copy_(master)
            new.append(p)
        else:
            new.append(master.to(g.dtype, copy=True))
    it = iter(new)
    return map_tree(lambda _: next(it), grads), state, gnorm
