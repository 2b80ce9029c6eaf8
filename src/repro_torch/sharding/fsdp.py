"""A rank's view of the ``data`` axis for its params: the reference's FSDP
(``PARAM_RULES["embed"] = [("data",), ()]``, "ZeRO-3 / FSDP axis"), the
data axis's counterpart of ``tensor_parallel``.

The reference lets GSPMD gather a param that ``param_shardings`` splits
over ``data`` where a product needs it whole, and reduce-scatter its
gradient. Here each rank holds its block of such a leaf, and AdamW's
master, ``m`` and ``v`` of it (``runtime.steps.shard_params`` /
``draw_params``: the reference's ``resolve_spec`` of the leaf on the
whole mesh, at this rank's coordinates), and the model code gathers a
leaf right before it is used:

    gather_data(block, dim)     the data group's blocks side by side along
                                dim, in data order (every rank's the same
                                bits); backward: the whole gradient in
                                f32, times this rank's label weight,
                                reduce-scattered over the data group (this
                                rank's block of the sum), summed over
                                ``pod`` where the step asks, cast to the
                                block's dtype
    gather_leaves(tree, dims)   ``gather_data`` leaf by leaf; the identity
                                for a leaf whole over data (dim None)
    gather_outer(params, skip)  every entry of a model's params but the
                                stacked segments ``skip``
    gather_layer(p, name)       layer ``p`` of the stacked segment
                                ``name`` (each dim one less: the layer dim
                                is gone)

The model code learns of the blocks from the rule context the step
enters (``rules.axis_rules(mesh, rules, data=DataBlocks(...))``):
``current()`` is that ``DataBlocks`` (this rank's ``DataAxis``, each
leaf's data dim, the label weight and the pod sum of the backward), else
None, and every helper is then the identity: the engine, the pipelined
decoder and one card hold whole params. A recompute
(``torch.utils.checkpoint`` under ``rules.recompute_context``) runs under
the forward's context, on whatever thread runs the backward.

``StackedLM`` gathers the leaves outside its segments (``embed``,
``ln_f``, ``head``, a VLM's ``patch_proj``) once a call at the entry of
``loss_fn``, ``prefill_fn`` and ``decode_fn`` (a tied embedding is
gathered once and used twice, so its gradient is reduce-scattered once),
and each layer's block weights inside the function that
``torch.utils.checkpoint`` wraps (the recompute gathers them again and
no whole leaf is saved for the backward), before ``prefill`` and layer by
layer in the decode loop. A model of another class (Whisper) is gathered
whole at the step's entry (``gather_leaves``).

The train step also tells the model code how the batch's rows lie over
ranks (``rules.axis_rules(..., rows=RowBlocks(...))``): an MoE layer in
training takes its capacity, and each routing decision's slot in its
expert, over the tokens of every row block in global order
(``earlier_rows``: one gather of per-expert counts), as the reference's
one logical batch has them, so a token is dropped on the ranks exactly
where one device drops it.

A gather does no arithmetic: a forward over gathered blocks is the
whole-param forward bit for bit. Every collective runs in the same order
on every rank of its group: the forward's in program order, the
backward's in autograd's (the same graph built in the same order), as
``tensor_parallel``'s are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.sharding import rules as R
from repro_torch.tree import map_tree


@dataclasses.dataclass
class DataAxis:
    """This rank on the ``data`` axis of a mesh of ranks: its index, the
    axis size, the axis's process group, and the host buffers of its
    gathers (``staging``) and of its reduce-scatters (``scatter``), each
    a ``launch.ranks.Staging`` that counts its bytes."""

    index: int
    size: int
    group: Any
    staging: Any
    scatter: Any


@dataclasses.dataclass
class DataBlocks:
    """A step's params over the data axis: this rank's ``axis``, ``dims``
    (the params tree with each leaf's data-split dim, None where the leaf
    is whole over data), the rank's label ``weight`` (a 0-d f32 tensor;
    None: the gradient is summed as it is) and ``pod``, the ``(group,
    staging)`` whose sum the backward also takes (None: no pod sum, as
    the compressed step exchanges over pod itself)."""

    axis: DataAxis
    dims: Any
    weight: Optional[torch.Tensor] = None
    pod: Optional[Tuple[Any, Any]] = None


@dataclasses.dataclass
class RowBlocks:
    """A train step's rows of the global batch over ranks: this rank's
    ``index`` among ``count`` row blocks in the batch's order, the
    ``group`` of the ranks holding them (in that order) and the
    ``staging`` of its messages."""

    index: int
    count: int
    group: Any
    staging: Any


# mesh id -> (the mesh, its DataAxis); a mesh lives as long as its steps
_AXES: Dict[int, Tuple[Any, DataAxis]] = {}


def axis_of(mesh) -> Optional[DataAxis]:
    """The ``DataAxis`` of this rank on ``mesh``, or None where the mesh
    is no ``DeviceMesh`` of ranks or its data axis is 1."""
    if mesh is None or not R.is_device_mesh(mesh) \
            or R.mesh_axis_sizes(mesh).get("data", 1) == 1:
        return None
    hit = _AXES.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist

    from repro_torch.launch import ranks as RK
    from repro_torch.launch.mesh import rank_axes
    ax = rank_axes(mesh)
    group = ax.group("data")
    if dist.get_rank(group) != ax.index("data"):
        raise ValueError("the data group's order is not the mesh's")
    out = DataAxis(ax.index("data"), ax.size("data"), group, RK.Staging(),
                   RK.Staging())
    _AXES[id(mesh)] = (mesh, out)
    return out


def current() -> Optional[DataBlocks]:
    """The ``DataBlocks`` of the active rule context, or None."""
    return R.current_data()


def earlier_rows(counts: torch.Tensor) -> Tuple[Optional[torch.Tensor], int]:
    """(the sum of ``counts`` over the row blocks before this rank's, the
    number of row blocks) over the active context's ``RowBlocks``; (None,
    1) where the rows are not split over ranks. ``counts`` has one shape
    on every rank of the group; no gradient."""
    rows = R.current_rows()
    if rows is None:
        return None, 1
    from repro_torch.launch import ranks as RK
    every = RK.all_gather(rows.staging, counts.detach().contiguous(),
                          rows.group, tag="row_counts")
    return every[:rows.index].sum(0), rows.count


class _GatherData(torch.autograd.Function):
    """The data group's blocks side by side; a block's gradient is its
    block of the group's weighted f32 sum of the whole gradients (and of
    the pods' where the step asks)."""

    @staticmethod
    def forward(ctx, block, blocks: DataBlocks, dim: int):
        from repro_torch.launch import ranks as RK
        ctx.blocks, ctx.dim, ctx.dtype = blocks, dim, block.dtype
        ax = blocks.axis
        every = RK.all_gather(ax.staging, block.contiguous(), ax.group,
                              tag="gather_data")
        if dim == 0:
            return every.reshape((-1,) + tuple(block.shape[1:]))
        return torch.cat(every.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.launch import ranks as RK
        blocks = ctx.blocks
        g = grad.float()
        if blocks.weight is not None:
            g = g * blocks.weight
        part = RK.reduce_scatter(blocks.axis.scatter, g, blocks.axis.group,
                                 tag="scatter_data", dim=ctx.dim)
        if blocks.pod is not None:
            group, staging = blocks.pod
            RK.all_reduce(staging, part, group, tag="pod_grads")
        return part.to(ctx.dtype), None, None


def gather_data(block: torch.Tensor, dim: Optional[int],
                blocks: Optional[DataBlocks] = None) -> torch.Tensor:
    """The whole leaf of which ``block`` is this rank's block along
    ``dim`` (``blocks``, by default the active context's, says over which
    group); ``block`` itself where ``dim`` is None or there are no
    blocks."""
    blocks = blocks or current()
    if blocks is None or dim is None:
        return block
    return _GatherData.apply(block, blocks, dim)


def gather_leaves(tree, dims, blocks: Optional[DataBlocks] = None):
    """``gather_data`` of each leaf of ``tree`` along its dim in ``dims``
    (a tree of one structure)."""
    blocks = blocks or current()
    if blocks is None:
        return tree
    return map_tree(lambda t, d: gather_data(t, d, blocks), tree, dims)


def gather_outer(params: Dict[str, Any], skip: Iterable[str]):
    """``params`` with every entry but those named in ``skip`` (a model's
    stacked segments, gathered a layer at a time) gathered whole."""
    blocks = current()
    if blocks is None:
        return params
    skip = set(skip)
    return {k: v if k in skip else gather_leaves(v, blocks.dims[k], blocks)
            for k, v in params.items()}


def gather_layer(p, name: str):
    """Layer ``p`` (one layer's views of the stacked block weights) of the
    segment ``name``, gathered whole over data."""
    blocks = current()
    if blocks is None:
        return p
    dims = map_tree(lambda d: None if d is None else d - 1,
                    blocks.dims[name])
    return gather_leaves(p, dims, blocks)
