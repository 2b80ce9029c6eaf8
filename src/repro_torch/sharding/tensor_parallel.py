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

Under ``SP_ACT_RULES`` (Megatron-SP: ``act_seq_sp`` over ``model``) the
residual stream between blocks is this rank's block of the sequence,
[B, S / M, d], where ``seq_split(S)`` says the rule resolves to
``model``; the sequence is whole inside attention and each product:

    gather_seq(x, share)        the group's sequence blocks side by side
                                (dim 1, model order); backward, with
                                ``share`` (x enters this rank's share of
                                work, as ``copy_to_model``'s input does)
                                the group's f32 sum of the gradients cut
                                to this rank's block (a reduce-scatter
                                in effect), without it this rank's block of the
                                gradient, the same on every rank
    reduce_scatter_seq(partial) this rank's sequence block of
                                ``reduce_model(partial)``, bit for bit:
                                its f32 all-reduce cut to the block;
                                backward: the blocks' gradients gathered
    keep_seq(x)                 this rank's sequence block of x, which
                                every rank holds whole; backward: the
                                blocks' gradients gathered
    enter(h, split, seq)        a normed ``h`` entering a product that is
                                ``split`` over model or not, the sequence
                                split (``seq``) or not: one of the above,
                                ``copy_to_model`` or ``h``
    leave(y, split, seq)        the product's output back on the residual
                                stream: ``reduce_scatter_seq``,
                                ``reduce_model``, ``keep_seq`` or ``y``

Where the KV heads stay whole over ``model`` (fewer KV heads than ranks)
the reference's ``cache_shardings`` gives a timeline cache's positions
to ``model`` (``act_kv_seq``; the distributed flash-decode). A step or
an engine that keeps a rank's block of the positions says so for the
model code's decode (``kv_positions``, with the whole horizon, read by
``positions_split`` and held by ``whole_positions``); a
decode step then attends each rank's block of positions with every
query head and combines the blocks' partial softmaxes:

    gather_heads(q)             the group's query heads side by side
                                (one [B, 1, H, D] message, ``q_gather``)
    combine_partials(m, l, o)   the group's (max, sum, unnormalized out)
                                partials, in f32, gathered in one message
                                (``combine``) and merged in rank order on
                                every rank, so each ends with the same
                                bits
    from_lead(x, ...)           model rank 0's ``x`` on every rank of the
                                group (a pipeline stage's activation,
                                opened once on model rank 0)

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
    messages (``Staging``, which counts their bytes): the sequence's
    gathers (``seq_gather``) and reduce-scatters (``seq_scatter``), the
    distributed flash-decode's query gathers (``q_gather``) and partial
    combines (``combine``) apart from the rest (``staging``)."""

    index: int
    size: int
    group: Any
    staging: Any
    seq_gather: Any
    seq_scatter: Any
    q_gather: Any = None
    combine: Any = None


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
                    *(RK.Staging() for _ in range(5)))
    _AXES[id(mesh)] = (mesh, out)
    return out


def current() -> Optional[ModelAxis]:
    """``axis_of`` the mesh of the active rule context."""
    return axis_of(R.current_mesh())


class _Logits(threading.local):
    keep: bool = False
    positions: int = 0


_LOGITS = _Logits()


@contextlib.contextmanager
def kv_positions(horizon: int = 0):
    """Inside (with a ``horizon`` above 0), the timeline caches the model
    code decodes over hold this rank's block of their ``horizon``
    positions (the distributed flash-decode, ``AttnBlock.attend_decode``):
    the caller that cut them says so, from ``kv_seq_splits`` of that
    horizon, and the model code holds every block it reads to horizon /
    M positions (``whole_positions``). 0: the positions are whole."""
    prev, _LOGITS.positions = _LOGITS.positions, int(horizon)
    try:
        yield
    finally:
        _LOGITS.positions = prev


def positions_split() -> Optional[ModelAxis]:
    """This rank's ``ModelAxis`` where ``kv_positions`` gave a horizon over
    a model axis, else None."""
    return current() if _LOGITS.positions else None


def whole_positions(held: int) -> int:
    """The whole horizon of a timeline cache that holds ``held`` positions
    here: ``held`` where the positions are whole, else ``kv_positions``'s
    horizon, which a block must be exactly 1 / M of (a cache cut to
    other positions than the caller said fails here by name)."""
    ax = positions_split()
    if ax is None:
        return held
    horizon = _LOGITS.positions
    if held * ax.size != horizon:
        raise ValueError(
            f"a timeline cache block of {held} positions on a model axis of "
            f"{ax.size} is not this rank's block of the {horizon} positions "
            f"kv_positions gave")
    return horizon


def local_slot(slot: torch.Tensor, S_local: int):
    """(this rank's index of the whole-horizon ``slot`` in its block of
    ``S_local`` positions, clamped into the block, and whether the block
    holds it): ``slot`` and True where the positions are whole."""
    ax = positions_split()
    if ax is None:
        return slot, torch.ones_like(slot, dtype=torch.bool)
    whole_positions(S_local)
    local = slot - ax.index * S_local
    own = (local >= 0) & (local < S_local)
    return torch.clamp(local, 0, S_local - 1), own


def kv_seq_splits(mesh, rules, num_kv_heads: int, seq_len: int) -> bool:
    """Whether ``rules`` give a timeline cache of ``seq_len`` positions
    and ``num_kv_heads`` KV heads its positions over the model axis of
    ``mesh`` (a mesh of ranks with a model axis above 1): ``resolve_spec``
    of one layer's [1, KVH, S, 1] over ``("act_kv_batch",
    "act_kv_heads", "act_kv_seq", None)`` puts ``model`` on S, as the
    reference's ``cache_shardings`` does where the KV heads do not divide
    (and S does)."""
    if rules is None or axis_of(mesh) is None:
        return False
    spec = R.resolve_spec((1, num_kv_heads, seq_len, 1),
                          ("act_kv_batch", "act_kv_heads", "act_kv_seq",
                           None), mesh, rules)
    return len(spec) > 2 and "model" in R._names(spec[2])


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


def seq_splits(mesh, rules, seq_len: int) -> bool:
    """Whether ``act_seq_sp`` under ``rules`` splits a residual stream of
    ``seq_len`` positions over the model axis of ``mesh``, a mesh of
    ranks with a model axis above 1: ``resolve_spec`` of [B, seq_len, d]
    over ``("act_batch", "act_seq_sp", "act_embed")`` gives the sequence
    ``model``. False under rules that keep it whole (``ACT_RULES``), or
    where ``seq_len`` does not divide (the rule's fallback ``()``: a
    decode step's one position)."""
    if rules is None or axis_of(mesh) is None:
        return False
    spec = R.resolve_spec((1, seq_len, 1),
                          ("act_batch", "act_seq_sp", "act_embed"), mesh,
                          rules)
    return len(spec) > 1 and "model" in R._names(spec[1])


def seq_split(seq_len: int) -> bool:
    """``seq_splits`` under the active rule context: whether a residual
    stream of ``seq_len`` positions is this rank's block of them."""
    return seq_splits(R.current_mesh(), R.current_rules(), seq_len)


def _group_sum(ax: ModelAxis, t: torch.Tensor, tag: str,
               staging=None) -> torch.Tensor:
    """The f32 sum of ``t`` over the model group, rounded once to ``t``'s
    dtype, in a new tensor (``t`` is not written); its bytes count in
    ``staging`` (default ``ax.staging``)."""
    from repro_torch.launch import ranks as RK
    total = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    total.copy_(t)
    RK.all_reduce(staging or ax.staging, total, ax.group, tag=tag)
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


def _scatter_sum(ax: ModelAxis, t: torch.Tensor) -> torch.Tensor:
    """This rank's block along dim 1 of the f32 sum of ``t`` over the model
    group, rounded once to ``t``'s dtype: ``_group_sum``'s all-reduce (the
    one ``reduce_model`` sends, the same partials added in the same order)
    cut to the block, so the block is ``reduce_model(t)``'s bit for bit
    over any number of ranks. A backend's reduce-scatter would move half
    the bytes on the wire but adds in its own order (gloo's over four
    ranks is not its all-reduce's). Its bytes count in ``seq_scatter``."""
    total = _group_sum(ax, t, "reduce_scatter_seq", ax.seq_scatter)
    return _own_block(ax, total).contiguous()


def _gather_blocks(ax: ModelAxis, x: torch.Tensor) -> torch.Tensor:
    """The group's blocks of ``x`` side by side along dim 1."""
    from repro_torch.launch import ranks as RK
    every = RK.all_gather(ax.seq_gather, x.contiguous(), ax.group,
                          tag="gather_seq")
    return torch.cat(every.unbind(0), dim=1)


def _own_block(ax: ModelAxis, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[1] // ax.size
    return x.narrow(1, ax.index * n, n)


class _GatherSeq(torch.autograd.Function):
    """The group's sequence blocks side by side; the input's gradient is
    the reduce-scatter of the ranks' shares (``share``) or this rank's
    block of a gradient every rank holds whole."""

    @staticmethod
    def forward(ctx, x, ax, share):
        ctx.ax, ctx.share = ax, share
        return _gather_blocks(ax, x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.share:
            return _scatter_sum(ctx.ax, grad), None, None
        return _own_block(ctx.ax, grad), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """This rank's sequence block of the group's f32 sum; the partial's
    gradient is the whole one, its blocks gathered."""

    @staticmethod
    def forward(ctx, partial, ax):
        ctx.ax = ax
        return _scatter_sum(ax, partial)

    @staticmethod
    def backward(ctx, grad):
        return _gather_blocks(ctx.ax, grad), None


class _KeepSeq(torch.autograd.Function):
    """This rank's sequence block of a tensor every rank holds whole; its
    gradient is the whole one, the blocks' gathered."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _own_block(ax, x).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return _gather_blocks(ctx.ax, grad), None


def gather_seq(x: torch.Tensor, share: bool = True) -> torch.Tensor:
    """The model group's sequence blocks of ``x`` [B, S / M, ...] side by
    side, [B, S, ...] (every rank's the same bits). Backward with
    ``share`` (``x`` enters work of which this rank does its share): this
    rank's block of the ranks' gradients summed in f32 and rounded once
    (``_scatter_sum``); without it
    (every rank's gradient is the whole one) this rank's block. The
    identity with no model axis."""
    ax = current()
    if ax is None:
        return x
    return _GatherSeq.apply(x, ax, share)


def reduce_scatter_seq(partial: torch.Tensor) -> torch.Tensor:
    """This rank's block along the sequence (dim 1) of the sum over the
    model group of each rank's ``partial``, added in f32 and rounded once
    (``reduce_model`` cut to the block, bit for bit: ``_scatter_sum``);
    backward,
    the blocks' gradients gathered. The identity with no model axis."""
    ax = current()
    if ax is None:
        return partial
    return _ReduceScatterSeq.apply(partial, ax)


def keep_seq(x: torch.Tensor) -> torch.Tensor:
    """This rank's block along the sequence (dim 1) of ``x``, which every
    rank holds whole; backward, the blocks' gradients gathered. The
    identity with no model axis."""
    ax = current()
    if ax is None:
        return x
    return _KeepSeq.apply(x, ax)


def enter(h: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """A normed ``h`` (the rank's sequence block where ``seq``) as it
    enters a product over this rank's shard (``split``) or over whole
    weights: gathered, as a share or whole, under a sequence split, else
    ``copy_to_model`` or ``h`` itself."""
    if seq:
        return gather_seq(h, share=split)
    return copy_to_model(h) if split else h


def leave(y: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """A product's output [B, S, ...] back on the residual stream: summed
    over the model group where ``split`` (reduce-scattered to the rank's
    block under a sequence split, ``seq``), else whole (the rank's block
    of it under a sequence split)."""
    if split:
        return reduce_scatter_seq(y) if seq else reduce_model(y)
    return keep_seq(y) if seq else y


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
                 vocab: int, seq: bool = False) -> torch.Tensor:
    """``table[ids]`` for an embedding of ``vocab`` rows, of which
    ``table`` holds this rank's block when the vocab is split: each rank
    looks up the ids in its block (zeros elsewhere) and the reduce adds
    the one nonzero row of each id, so the rows are the whole table's
    bit for bit. Backward: the reduce passes the rows' gradient to every
    rank, and the masked lookup gives it to the rank's own rows only.
    With ``seq`` (a sequence split) the rows are this rank's block of
    the sequence (``leave``: the reduce is a reduce-scatter)."""
    ids = ids.long()
    if not split(table.shape[0], vocab):
        return leave(table[ids], False, seq)
    n = table.shape[0]
    local = ids - current().index * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return leave(rows, True, seq)


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


def gather_heads(q: torch.Tensor) -> torch.Tensor:
    """The model group's query heads of ``q`` [B, 1, H / M, D] side by side,
    [B, 1, H, D], in model order (the flash-decode's one query message,
    counted in ``q_gather``); ``q`` with no model axis."""
    ax = current()
    if ax is None:
        return q
    from repro_torch.launch import ranks as RK
    every = RK.all_gather(ax.q_gather, q.contiguous(), ax.group,
                          tag="gather_heads")
    return torch.cat(every.unbind(0), dim=2)


def combine_partials(m: torch.Tensor, l: torch.Tensor,
                     o: torch.Tensor) -> torch.Tensor:
    """Softmax attention over the whole cache from each rank's partial
    over its block of positions: ``m`` [..] the block's max score (the
    mask's ``NEG_INF`` for an empty block), ``l`` [..] its sum of
    ``exp(score - m)``, ``o`` [.., D] the sum of those weights times V,
    all f32. The group's partials are gathered in one message
    (``combine``) and every rank merges them in rank order: with M* the
    max of the blocks' maxima, the output is ``sum_j exp(m_j - M*) o_j /
    sum_j exp(m_j - M*) l_j``, the same bits on every rank. An empty
    block weighs exp(NEG_INF - M*) = 0 beside a block with a valid
    position; a row with none anywhere gets the mean of V over the
    horizon, as ``L.decode_attention``'s softmax over ``NEG_INF`` gives.
    Returns f32 [.., D]."""
    ax = current()
    from repro_torch.launch import ranks as RK
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1)
    every = RK.all_gather(ax.combine, packed.contiguous(), ax.group,
                          tag="combine_partials")              # [M, .., D+2]
    ms, ls, os_ = every[..., 0], every[..., 1], every[..., 2:]
    top = ms.amax(0)
    total = torch.zeros_like(l)
    out = torch.zeros_like(o)
    for j in range(ax.size):
        w = torch.exp(ms[j] - top)
        total = total + w * ls[j]
        out = out + w[..., None] * os_[j]
    return out / total[..., None]


def from_lead(x: Optional[torch.Tensor], shape, dtype,
              device) -> torch.Tensor:
    """Model rank 0's ``x`` (others pass None) on every rank of the model
    group, a broadcast counted in ``staging``; ``x`` itself with no model
    axis."""
    ax = current()
    if ax is None:
        return x
    from repro_torch.launch import ranks as RK
    if ax.index != 0:
        x = torch.empty(shape, dtype=dtype, device=device)
    else:
        x = x.reshape(shape).contiguous()
    src = RK.group_ranks(ax.group)[0]
    return RK.broadcast(ax.staging, x, src, ax.group, tag="from_lead")
