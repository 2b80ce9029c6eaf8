"""A rank's view of the ``model`` axis (tensor parallelism over ranks).

The reference marks its model code with ``constrain`` and lets GSPMD
insert the collectives. Here each device of a mesh is a rank
(``launch.ranks``), each rank holds its shard of the params
(``runtime.steps.shard_params``) and the model code asks this module for
the messages a shard needs. The model code learns that it runs on a
model-sharded rank from the rule context the step enters
(``rules.axis_rules(mesh, rules)``): ``current()`` is this rank's
``ModelAxis`` when that mesh is a ``DeviceMesh`` of ranks with a
``model`` axis above 1, else None, and every helper below is then the
identity. No model function takes a mesh argument.

    reduce_model(partial)       the sum over the model group of the
                                partial outputs of a product that
                                contracts a model-split dim, in f32,
                                rounded once to the partial's dtype;
                                backward: the identity
    copy_to_model(x)            x, which every rank holds whole, entering
                                work that only this rank's share does;
                                backward: the sum over the group
    gather_model(x, dim)        the group's shards of x side by side
                                along dim, in model order; backward:
                                this rank's block of the gradient
    embed_lookup(table, ids)    rows of a vocab-split embedding: a
                                masked local lookup, then a reduce
    max_model(x)                the elementwise max over the group (no
                                gradient: a softmax's shift)
    keep_vocab_split()          a context in which a vocab-split head's
                                logits stay this rank's block of columns
                                (a serve step's ``sharded_logits``)

Every model-axis message goes through these, so each has its backward
(a ``torch.autograd.Function``) in one place and a count on meta tensors
can see them all. A tensor every rank holds whole has the same value and
the same gradient on every rank: a product over this rank's shard gives
its input only this rank's share of that gradient, which
``copy_to_model`` sums; a reduce's output gradient is every partial's.
Outside autograd a Function runs its forward alone (``copy_to_model``
is then the identity). ``split(local,
whole)`` tells a call site whether its operand holds a shard (the
divisibility fallback of ``rules.resolve_spec`` keeps a dim whole when
it does not divide), and ``kv_for_heads`` picks the KV heads a rank's
query heads read when the KV heads stayed whole.

In a backward the collectives run in autograd's order, which is the same
on every rank of a group (the same graph built in the same order); a
recomputed forward (``torch.utils.checkpoint``) issues its collectives
again, at the same point of that order on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.sharding import rules as R


@dataclasses.dataclass
class ModelAxis:
    """This rank on the ``model`` axis of a mesh of ranks: its index, the
    axis size, the axis's process group and the host buffers of its
    messages (``Staging``, which counts their bytes)."""

    index: int
    size: int
    group: Any
    staging: Any


# mesh id -> (the mesh, its ModelAxis); a mesh lives as long as its step
_AXES: Dict[int, Tuple[Any, ModelAxis]] = {}


def axis_of(mesh) -> Optional[ModelAxis]:
    """The ``ModelAxis`` of this rank on ``mesh``, or None where the mesh
    is no ``DeviceMesh`` of ranks or its model axis is 1."""
    if mesh is None or not R.is_device_mesh(mesh) \
            or R.mesh_axis_sizes(mesh).get("model", 1) == 1:
        return None
    hit = _AXES.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist

    from repro_torch.launch import ranks as RK
    from repro_torch.launch.mesh import rank_axes
    ax = rank_axes(mesh)
    group = ax.group("model")
    if dist.get_rank(group) != ax.index("model"):
        raise ValueError("the model group's order is not the mesh's")
    out = ModelAxis(ax.index("model"), ax.size("model"), group,
                    RK.Staging())
    _AXES[id(mesh)] = (mesh, out)
    return out


def current() -> Optional[ModelAxis]:
    """``axis_of`` the mesh of the active rule context."""
    return axis_of(R.current_mesh())


class _Logits(threading.local):
    keep: bool = False


_LOGITS = _Logits()


@contextlib.contextmanager
def keep_vocab_split(on: bool = True):
    """Inside (with ``on``), a vocab-split head's logits are this rank's
    block of columns, not gathered over the model group."""
    prev, _LOGITS.keep = _LOGITS.keep, on
    try:
        yield
    finally:
        _LOGITS.keep = prev


def vocab_kept() -> bool:
    """Whether ``keep_vocab_split`` is on."""
    return _LOGITS.keep


def split(local: int, whole: int) -> bool:
    """Whether an operand dim of ``local`` entries (of ``whole`` in the
    unsplit model) holds a shard on this rank: False with no model
    axis."""
    return current() is not None and local != whole


def _group_sum(ax: ModelAxis, t: torch.Tensor, tag: str) -> torch.Tensor:
    """The f32 sum of ``t`` over the model group, rounded once to ``t``'s
    dtype, in a new tensor (``t`` is not written)."""
    from repro_torch.launch import ranks as RK
    total = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    total.copy_(t)
    RK.all_reduce(ax.staging, total, ax.group, tag=tag)
    return total.to(t.dtype)


class _ReduceModel(torch.autograd.Function):
    """The group's f32 sum; the output's gradient is every partial's."""

    @staticmethod
    def forward(ctx, partial, ax):
        return _group_sum(ax, partial, "reduce_model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """The identity; the input's gradient is the group's sum of the
    rank's shares."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _group_sum(ctx.ax, grad, "copy_to_model"), None


class _GatherModel(torch.autograd.Function):
    """The group's shards side by side; a shard's gradient is its block
    of the whole one's (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        from repro_torch.launch import ranks as RK
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        every = RK.all_gather(ax.staging, x.contiguous(), ax.group,
                              tag="gather_model")
        return torch.cat(every.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


def reduce_model(partial: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each rank's ``partial`` (a product
    over its shard of the contracted dim), added in f32 and rounded once
    to ``partial``'s dtype, in a new tensor; the same bits on every rank
    of the group. The identity with no model axis."""
    ax = current()
    if ax is None:
        return partial
    return _ReduceModel.apply(partial, ax)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank) where it enters work that only this
    rank's shard does (a product with split columns, the rank's experts,
    its vocab block): the identity forward; backward, the sum over the
    model group of the ranks' gradients, in f32 rounded once. The
    identity with no model axis or outside autograd."""
    ax = current()
    if ax is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, ax)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's shards of ``x`` side by side along ``dim``, in
    model order (every rank's the same); the identity with no model
    axis."""
    ax = current()
    if ax is None:
        return x
    return _GatherModel.apply(x, ax, dim)


def max_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model group, in a new tensor
    without gradient (every rank's the same bits); ``x`` itself with no
    model axis."""
    ax = current()
    if ax is None:
        return x
    from repro_torch.launch import ranks as RK
    return RK.all_reduce(ax.staging, x.detach().clone(
        memory_format=torch.contiguous_format), ax.group, tag="max_model",
        op="max")


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``table[ids]`` for an embedding of ``vocab`` rows, of which
    ``table`` holds this rank's block when the vocab is split: each rank
    looks up the ids in its block (zeros elsewhere) and the reduce adds
    the one nonzero row of each id, so the rows are the whole table's
    bit for bit. Backward: the reduce passes the rows' gradient to every
    rank, and the masked lookup gives it to the rank's own rows only."""
    ids = ids.long()
    if not split(table.shape[0], vocab):
        return table[ids]
    n = table.shape[0]
    local = ids - current().index * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_model(rows)


def kv_for_heads(num_heads: int, num_kv_heads: int, local_heads: int,
                 local_kv: int) -> Union[slice, torch.Tensor, None]:
    """The KV heads this rank's ``local_heads`` query heads read when its
    K and V hold all ``num_kv_heads`` (``local_kv``; the KV heads stayed
    whole while the query heads split): global query head h reads KV
    head h // rep, rep = num_heads / num_kv_heads. A slice where every KV
    head it names serves the same number of the rank's heads (the rank then attends with that
    many heads a KV head, the one-card kernel's grouping); else an index
    of one KV head for each of its query heads (K and V expanded, one
    query head a KV head). None where the query heads are whole or the KV
    heads split with them (each rank's KV heads are then its heads')."""
    if not split(local_heads, num_heads) or local_kv != num_kv_heads:
        return None
    rep = num_heads // num_kv_heads
    first = current().index * local_heads
    kv = [(first + j) // rep for j in range(local_heads)]
    counts = [kv.count(g) for g in range(kv[0], kv[-1] + 1)]
    if len(set(counts)) == 1:
        return slice(kv[0], kv[-1] + 1)
    return torch.tensor(kv, dtype=torch.long)


def take_kv(t: torch.Tensor, which, dim: int) -> torch.Tensor:
    """``t``'s KV heads ``which`` (``kv_for_heads``) along ``dim``, a
    contiguous tensor (the flash kernel's input)."""
    if which is None:
        return t
    if isinstance(which, slice):
        return t.narrow(dim, which.start,
                        which.stop - which.start).contiguous()
    return t.index_select(dim, which.to(t.device))
