"""Cross-pod gradient compression with error feedback (the port of
``repro/optim/compression.py``).

Each pod computes gradients over its own rows of the batch, then pods
exchange int8-quantized gradients (one byte an element on the wire
instead of four, plus one f32 scale a leaf) and fold the quantization
error into an error-feedback buffer that is added back before the next
step: the standard EF-SGD trick, so the compression is unbiased over
time.

Here a pod is a rank (``launch.ranks``) and ``group`` the process group
of this rank's ``pod`` axis: two pods swap their payloads with one
message each way; more than two reduce in f32 (as the reference's
fallback). The arithmetic is the reference's program in f32, as XLA
compiles it: ``_quantize`` takes one absmax a leaf and
``scale = max(absmax, 1e-12) / 127``, which XLA folds into a multiply by
the f32 constant 1/127 (one ulp off the quotient for about 4% of
absmaxes), then ``q = clip(round_half_even(g / scale), -127, 127)`` by
true division (by a device tensor: PyTorch multiplies a CUDA tensor by
the reciprocal of a host scalar divisor). The f32 fallback's
``psum / num_pods`` is folded the same way. Both pods end with the same
bits: ``(mine + theirs) * 0.5`` commutes.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.launch import ranks as RK
from repro_torch.tree import leaves, map_tree


def _f32_reciprocal(n: int, like: torch.Tensor) -> torch.Tensor:
    """The f32 constant 1/n on ``like``'s device (XLA's folded divisor)."""
    return torch.full((), 1.0 / n, dtype=torch.float32, device=like.device)


def _quantize(g: torch.Tensor, absmax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 leaf -> (int8 q of its shape, 0-d f32 scale); ``absmax``
    the leaf's largest |value| where ``g`` is a shard of it."""
    if absmax is None:
        absmax = g.abs().amax()
    scale = absmax.clamp_min(1e-12) * _f32_reciprocal(127, absmax)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _unflatten(tree, flat):
    it = iter(flat)
    return map_tree(lambda _: next(it), tree)


def compressed_psum_pod(grads: Any, ef: Any, group, num_pods: int,
                        staging: Optional[RK.Staging] = None,
                        leaf_absmax: Optional[Callable] = None):
    """grads, ef: trees of one structure (grads f32 or bf16, ef f32).
    Returns (the pods' mean gradient in f32, the new ef). Every rank of
    ``group`` (this rank's ``pod`` axis) calls it with its pod's gradient.
    Two pods: each sends its int8 payload and scales to the other in one
    message and takes ``(mine + theirs) * 0.5``; the new ef is
    ``g + ef - mine``. More pods: the f32 sum over ``group`` divided by
    ``num_pods``, ef unchanged. Both trees are donated, as the reference's
    step donates them: ef is updated in place, and an f32 gradient leaf
    receives its reduced value (at full width each saves a copy of the f32
    parameter bytes). Where the trees hold a rank's shards of a model
    split over ranks, ``leaf_absmax`` maps the [n] vector of this rank's
    per-leaf absmaxes to the whole leaves' (the max over the model
    group), so each shard is quantized on its whole leaf's scale, as the
    reference's ``_quantize`` sees the whole leaf."""
    staging = staging or RK.Staging()
    g_leaves = leaves(grads)
    dev = g_leaves[0].device
    if num_pods != 2:
        sizes = [g.numel() for g in g_leaves]
        flat = torch.cat([g.float().reshape(-1) for g in g_leaves])
        RK.all_reduce(staging, flat, group, tag="pods_f32")
        flat = flat * _f32_reciprocal(num_pods, flat)
        out = [part.reshape(g.shape) for part, g in
               zip(flat.split(sizes), g_leaves)]
        return _unflatten(grads, out), ef
    peer = RK.peer_of(group)
    e_leaves = leaves(ef)
    q_flat = torch.empty(sum(g.numel() for g in g_leaves), dtype=torch.int8,
                         device=dev)
    scales = torch.empty(len(g_leaves), dtype=torch.float32, device=dev)
    gfs = [e.add_(g) for g, e in zip(g_leaves, e_leaves)]  # in ef's buffers
    absmax = [None] * len(gfs)
    if leaf_absmax is not None:
        absmax = leaf_absmax(torch.stack([gf.abs().amax() for gf in gfs]))
    off = 0
    for i, gf in enumerate(gfs):
        q, scales[i] = _quantize(gf, absmax[i])
        q_flat[off:off + q.numel()] = q.reshape(-1)
        off += q.numel()
    q_peer, scales_peer = RK.exchange(staging, [q_flat, scales], peer,
                                      group, tag="pods_q8")
    reduced, off = [], 0
    for i, (g, gf) in enumerate(zip(g_leaves, e_leaves)):
        n = gf.numel()
        mine = q_flat[off:off + n].reshape(gf.shape).float() * scales[i]
        theirs = q_peer[off:off + n].reshape(gf.shape).float() \
            * scales_peer[i]
        off += n
        out = g if g.dtype == torch.float32 else torch.empty_like(gf)
        reduced.append(torch.add(mine, theirs, out=out).mul_(0.5))
        gf.sub_(mine)                         # the new ef: g + e - mine
    return _unflatten(grads, reduced), ef


def exchanged_bytes(params) -> int:
    """Bytes one pod sends a step with two pods: one per element and one
    f32 scale a leaf (against four per element uncompressed)."""
    return sum(p.numel() + 4 for p in leaves(params))


def init_error_feedback(params) -> Any:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
