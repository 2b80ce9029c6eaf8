"""Step builders of the port (``repro/runtime/steps.py``): the train step,
the prefill and decode serve steps, their sharding trees and
``abstract_inputs``, the stand-ins the dry-run counts.

The sharding trees (``param_shardings``, ``opt_shardings``,
``batch_shardings``, ``cache_shardings``) resolve every leaf's logical
axes on a mesh (``repro_torch.sharding``), a ``DeviceMesh`` or a logical
one. With no mesh or on a mesh of one, the tensors stay plain tensors on
the model's device, so the hand-written kernels (launched through ctypes,
which a DTensor would not reach) run as they do everywhere else. On the
meta device a step runs over a logical mesh of any size, placing nothing:
the dry-run counts it.

The train step also runs over a mesh of ranks (``launch.ranks.spawn``;
``make_mesh`` in each rank gives a ``DeviceMesh`` of the world): axes
drawn from ``pod``, ``data`` and ``model``. Each rank holds plain
tensors, takes its rows of the global batch (pod-major, as the
reference's batch sharding lays them out; the model ranks of a (pod,
data) position take the same rows) and reduces with explicit
collectives on the process group of an axis (``launch.ranks``). The plain
step averages the gradient and the loss over the (pod, data) positions,
each weighted by its count of unmasked labels, so a ``label_mask`` that
gives the ranks unequal counts still gives the batch's mean; with a
model axis the reduce runs over the ranks that hold the same model
index (``mesh.ROWS``). The compressed step (``compress_pod_grads``, the
reference's ``_make_train_step_compressed``) averages within a pod over
its ``data`` group the same way, exchanges the pod's gradient as int8
with error feedback over ``pod`` (``optim.compression``) and takes the
pods' mean loss. The prefill and decode serve steps run over the same
meshes: each rank its block of the batch's rows, the logits gathered
whole on every rank (with ``sharded_logits``, each rank's block of
them).

On a mesh of ranks each rank holds its block of every param leaf as the
reference's ``param_shardings`` place it: ``param_rules`` (by default
``PARAM_RULES``) resolved on the whole mesh at the rank's coordinates
(``leaf_block``, ``param_blocks``), and AdamW's state with it. Over
``data`` (ROADMAP item 10d, step 8, the reference's FSDP: every leaf
with an ``embed`` dim) the model gathers a leaf over the data group
before use and the backward reduce-scatters its gradient, weighted by
the rank's label count and summed over pods (``sharding.fsdp``); the
leaves whole over data join the weighted sum above. An MoE layer in
training routes over the whole batch's rows (``fsdp.RowBlocks``), as
the reference's one logical batch does.

The serve steps (ROADMAP item 10d, step 5a) and the train step (step
5b) also run over a ``model`` axis above 1 (tensor parallelism) for the
dense and MoE stacks:
each rank holds its block of the params (``shard_params`` of the whole
tree, or ``draw_params`` leaf by leaf from a seed), split over ``model``
(and ``data``) as ``param_shardings`` resolves them with
``PARAM_RULES``, and the model code, told by the rule
context that it runs on a model-split rank, adds the messages a shard
needs (``sharding.tensor_parallel``: a reduce after each product that
contracts a split dim, the vocab-split embedding and logits). The model
ranks of a row block run the same rows and return the same whole logits;
each returns its rows of the cache with its KV heads where they divide
over ``model``. Where they do not, ``cache_shardings`` gives the
positions to ``model`` when they divide (``TP.kv_seq_splits`` of the
step's whole horizon): the prefill step returns each rank its block of
the positions (every rank computes every KV head there, so the cut
sends nothing), and the decode step takes and returns that block, each
rank attending its positions with every query head and the blocks'
partial softmaxes combined over the model group (the reference's
distributed flash-decode, ``AttnBlock.flash_decode``; its two messages a
layer counted in the step's ``q_gather_staging`` and
``combine_staging``). A horizon that does not divide keeps every
position on every rank, as the reference's fallback. In the train step every
helper's backward gives each rank its shards' gradients and the whole
leaves' (the norms, the router, KV heads that stay whole) the same bits
on every rank; the clipping norm counts each block once over the pod's
(data, model) ranks (``ModelShards``), and the compressed step
quantizes each block on its whole leaf's absmax. Under ``SP_ACT_RULES``
(Megatron-SP, step 5b) the residual stream between blocks is each model
rank's block of the sequence where ``act_seq_sp`` resolves to ``model``
(``TP.seq_splits``; a sequence that does not divide, a decode step's
one position among them, runs as without the rules): the norms then see
only the rank's block, and the train step sums their gradients over the
model group once a step (``_norms_sum``).
Refused by name over a model axis: families other than the dense and
MoE ``StackedLM`` and the int8 cache (step 5c). A logical mesh of
several devices in a process of one rank is refused by name (item 10).

On the card the train step runs under ``torch.use_deterministic_algorithms``,
so a run repeats its bits and a resumed run ends where a straight one
does: the embedding's backward (an index with accumulate) and the loss's
gather backward take their sorted, atomic-free forms. That mode needs
``CUBLAS_WORKSPACE_CONFIG`` in the environment before cuBLAS starts; the
launcher sets it first thing, and ``make_train_step`` sets it if no one
has.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.launch import ranks as RK
from repro_torch.launch.mesh import LOCAL, ROWS, rank_axes
from repro_torch.models.api import ModelAPI
from repro_torch.models.layers import init_one
from repro_torch.models.transformer import (AttnBlock, StackedLM, _map_specs,
                                            is_spec, map_specs)
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.optim.compression import compressed_psum_pod
from repro_torch.sharding import rules as R
from repro_torch.sharding import fsdp as FS
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.tree import leaves, map_tree, named_leaves

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


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------
def param_shardings(api: ModelAPI, mesh, rules=None):
    rules = rules or R.PARAM_RULES
    return map_tree(lambda s: R.logical_sharding(s.shape, s.axes, mesh,
                                                 rules), api.param_specs())


def opt_shardings(api: ModelAPI, mesh, rules=None) -> AdamWState:
    ps = param_shardings(api, mesh, rules)
    return AdamWState(ps, ps, ps)


def batch_shardings(api: ModelAPI, shape: ShapeConfig, mesh,
                    rules=None) -> Dict[str, Any]:
    rules = rules or R.ACT_RULES
    axes = api.input_axes(shape)
    specs = api.input_specs(shape)
    return {k: R.logical_sharding(specs[k][0], axes[k], mesh, rules)
            for k in specs}


def zip_specs(fn, specs, axes):
    """``fn(spec, axes)`` over a cache spec tree and its axes tree."""
    if is_spec(specs):
        return fn(specs, axes)
    if isinstance(specs, dict):
        return {k: zip_specs(fn, v, axes[k]) for k, v in specs.items()}
    return tuple(zip_specs(fn, v, a) for v, a in zip(specs, axes))


def cache_shardings(api: ModelAPI, batch: int, mesh, rules=None,
                    max_seq: Optional[int] = None):
    rules = rules or R.ACT_RULES
    return zip_specs(
        lambda s, a: R.logical_sharding(s[0], tuple(a), mesh, rules),
        api.init_cache_specs(batch, max_seq),
        api.init_cache_axes(batch, max_seq))


def replicated(mesh) -> R.NamedSharding:
    return R.NamedSharding(mesh, ())


def check_mesh(api: ModelAPI, mesh, what: str) -> None:
    """The meshes a step of the port runs over: none, a mesh of one
    device (a ``DeviceMesh`` on the model's device type, or a logical
    one), any logical mesh when the model is on ``meta``, where nothing
    is placed, and a ``DeviceMesh`` of the world's ranks over ``pod``,
    ``data`` and ``model``, a model axis above 1 for the dense and MoE
    ``StackedLM`` only (``check_model_axis``). Anything else raises by
    name."""
    if mesh is None:
        return
    n = R.mesh_size(mesh)
    if R.is_device_mesh(mesh) and mesh.device_type != api.device.type:
        raise ValueError(f"{what}: mesh on {mesh.device_type} but the "
                         f"model is on {api.device}")
    if n == 1 or api.device.type == "meta":
        return
    sizes = R.mesh_axis_sizes(mesh)
    if R.is_device_mesh(mesh):
        wide = {a: k for a, k in sizes.items()
                if a not in ("pod", "data", "model") and k > 1}
        if wide:
            raise NotImplementedError(
                f"{what}: mesh axes {wide}: ranks run over pod, data and "
                f"model (ROADMAP queue 1, item 10d)")
        if sizes.get("model", 1) > 1:
            check_model_axis(api, sizes["model"], what)
        return
    raise NotImplementedError(
        f"{what}: a logical mesh of {n} devices {sizes} in a process of "
        f"one rank places nothing; run one rank per device "
        f"(launch/ranks.py) or count on meta tensors (ROADMAP queue 1, "
        f"item 10)")


def check_model_axis(api: ModelAPI, m: int, what: str) -> None:
    """What a model axis of ``m`` ranks runs (ROADMAP item 10d, steps 5a,
    5b and 5c's first part): the prefill and decode serve steps, the
    train step, the serving engine and ``PipelinedDecoder`` of the dense
    and MoE ``StackedLM`` (one ``AttnBlock`` class in every segment),
    from a bf16 or f32 cache (paged, or the timeline with its positions
    over ``model`` where the KV heads do not divide), under rules that
    keep the sequence whole or split it over ``model`` (``act_rules``,
    ``SP_ACT_RULES``). The rest (the other families, the int8 cache)
    raises by name with its roadmap step."""
    model, cfg = api.model, api.cfg
    if type(model) is not StackedLM or any(
            type(seg.block) is not AttnBlock for seg in model.segments):
        raise NotImplementedError(
            f"{what}: {cfg.name} ({type(model).__name__}) over a model "
            f"axis of {m}: tensor parallelism covers the dense and MoE "
            f"StackedLM stacks; the other families are ROADMAP item 10d, "
            f"step 5c")
    if model.cache_quant:
        raise NotImplementedError(
            f"{what}: the int8 timeline cache over a model axis of {m} "
            f"(its per-head scales) is ROADMAP item 10d, step 5c")


# ---------------------------------------------------------------------------
# A rank's block of the params on the whole mesh
# ---------------------------------------------------------------------------
def leaf_block(spec, mesh, coords: Dict[str, int], rules=None
               ) -> Optional[Tuple[slice, ...]]:
    """The block of a leaf of ``spec`` (a ``ParamSpec``) that the device
    at ``coords`` ({mesh axis: index}) of ``mesh`` holds, or None where
    the leaf stays whole: its ``axes`` resolved by ``resolve_spec`` with
    ``rules`` (``PARAM_RULES`` by default) on the whole mesh, the
    reference's ``param_shardings``, so a dim that does not divide stays
    whole as the reference's fallback keeps it. The one decision behind
    ``param_blocks``, ``shard_params``, ``draw_params``, ``check_shards``,
    ``ModelShards`` and the data axis's gathers (``data_dims``)."""
    sh = R.logical_sharding(spec.shape, spec.axes, mesh,
                            rules or R.PARAM_RULES)
    return None if sh.is_replicated else sh.block(spec.shape, coords)


def _on_ranks(mesh) -> bool:
    return mesh is not None and R.is_device_mesh(mesh) \
        and R.mesh_size(mesh) > 1


def param_blocks(api: ModelAPI, mesh, coords: Optional[Dict[str, int]] = None,
                 rules=None) -> List[Optional[Tuple[slice, ...]]]:
    """``leaf_block`` of each leaf of ``api.param_specs()``, in leaf
    order, at ``coords`` of ``mesh`` (a mesh of ranks, or any mesh with
    ``coords``); by default this rank's coordinates on a mesh of ranks,
    and every leaf whole elsewhere (no mesh, a mesh of one device, a
    logical mesh in a process of one rank)."""
    specs = leaves(api.param_specs())
    if coords is None:
        if not _on_ranks(mesh):
            return [None] * len(specs)
        coords = rank_axes(mesh).coords
    return [leaf_block(sp, mesh, coords, rules) for sp in specs]


def join_blocks(api: ModelAPI, mesh, trees, rules=None):
    """The whole params-shaped tree (params, or one of AdamW's states) on
    the host from ``trees``, each rank's blocks of it in rank order (the
    ranks of ``mesh``, any mesh, in its axes' row-major order): each
    rank's block written where ``param_blocks`` puts it."""
    sizes = R.mesh_axis_sizes(mesh)
    wholes = [torch.empty(sp.shape, dtype=t.dtype) for sp, t in zip(
        leaves(api.param_specs()), leaves(trees[0]))]
    for r, tree in enumerate(trees):
        at = np.unravel_index(r, tuple(sizes.values()))
        coords = {a: int(c) for a, c in zip(sizes, at)}
        for w, blk, t in zip(wholes, param_blocks(api, mesh, coords, rules),
                             leaves(tree)):
            w[blk if blk is not None else ...] = t.detach().cpu()
    it = iter(wholes)
    return map_tree(lambda _: next(it), trees[0])


def _split_dims(shape, axes, mesh, rules) -> Dict[str, int]:
    """{mesh axis of more than one device: the dim it splits} of a tensor
    of ``shape`` over logical ``axes`` under ``rules`` (``PARAM_RULES``
    by default)."""
    sizes = R.mesh_axis_sizes(mesh)
    sh = R.logical_sharding(shape, axes, mesh, rules or R.PARAM_RULES)
    return {a: d for d, entry in enumerate(sh.spec)
            for a in R._names(entry) if sizes[a] > 1}


def split_axes(api: ModelAPI, mesh, rules=None) -> List[Tuple[str, ...]]:
    """The mesh axes (of more than one device) that split each leaf of
    ``api.param_specs()``, in leaf order and mesh order; none off a mesh
    of ranks."""
    specs = leaves(api.param_specs())
    if not _on_ranks(mesh):
        return [()] * len(specs)
    order = list(R.mesh_axis_sizes(mesh))
    return [tuple(sorted(_split_dims(sp.shape, sp.axes, mesh, rules),
                         key=order.index)) for sp in specs]


def data_dims(api: ModelAPI, mesh, rules=None):
    """The params tree with each leaf's dim over ``data`` (None where the
    leaf is whole over data, or the mesh has no data axis above 1): what
    ``sharding.fsdp`` gathers."""
    return map_tree(lambda sp: _split_dims(sp.shape, sp.axes, mesh,
                                               rules).get("data"),
                    api.param_specs())


def check_param_rules(api: ModelAPI, mesh, rules, what: str) -> None:
    """What a ``param_rules`` table may do on a mesh of ranks: ``data``
    takes any dim of a leaf but a stack's ``layers`` (the gather is
    generic, one layer at a time), alone; ``model`` lands where
    ``PARAM_RULES`` puts it (the tensor-parallel call sites split those
    dims only); ``pod`` takes only ``stages``. Anything else raises by
    name, with its roadmap step."""
    if rules is None or rules is R.PARAM_RULES or not _on_ranks(mesh):
        return
    for name, sp in named_leaves(api.param_specs()).items():
        got = _split_dims(sp.shape, sp.axes, mesh, rules)
        want = _split_dims(sp.shape, sp.axes, mesh, R.PARAM_RULES)
        if got.get("model") != want.get("model"):
            where = lambda d: "nowhere" if d is None else repr(sp.axes[d])
            raise NotImplementedError(
                f"{what}: param_rules put model on {where(got.get('model'))}"
                f" of {name} {sp.axes}, PARAM_RULES on "
                f"{where(want.get('model'))}: the tensor-parallel call "
                f"sites split PARAM_RULES' dims only (ROADMAP item 10d, "
                f"step 5c)")
        if "pod" in got and sp.axes[got["pod"]] != "stages":
            raise NotImplementedError(
                f"{what}: param_rules put pod on {sp.axes[got['pod']]!r} "
                f"of {name}: pod takes only pipeline stages, which the "
                f"pipelined decoder places itself (ROADMAP item 10d, "
                f"step 5c)")
        d = got.get("data")
        shared = d is not None and sum(a == d for a in got.values()) > 1
        if d is not None and (sp.axes[d] == "layers" or shared):
            raise NotImplementedError(
                f"{what}: param_rules put data on {sp.axes[d]!r} of "
                f"{name} {sp.axes}{' with another axis' * shared}: the "
                f"data axis gathers one layer at a time, along a dim of "
                f"its own (ROADMAP item 10d, step 8)")


def shard_params(api: ModelAPI, mesh, params, rules=None,
                 coords: Optional[Dict[str, int]] = None):
    """This rank's block (or the block at ``coords``) of each leaf of the
    whole tree ``params`` (``param_blocks``). A split leaf is a new tensor
    (the whole can be freed), a whole one the same tensor."""
    blocks = iter(param_blocks(api, mesh, coords, rules))

    def cut(t):
        blk = next(blocks)
        return t if blk is None else t[blk].clone()

    return map_tree(cut, params)


def draw_params(api: ModelAPI, mesh, generator: torch.Generator,
                rules=None):
    """``shard_params(api, mesh, api.init(generator))``, bit for bit: on
    no mesh of ranks ``api.init(generator)`` itself; on one, each leaf
    drawn from ``generator`` in ``api.init``'s order (every model's
    ``init_params`` draws its ``param_specs`` in order), keeping only this
    rank's block before the next, so a rank's peak is one whole leaf in
    f32 beside its blocks, not the model."""
    if not _on_ranks(mesh):
        return api.init(generator)
    coords = rank_axes(mesh).coords
    return _map_specs(lambda spec: init_one(
        spec, generator, api.device, api.dtype,
        block=leaf_block(spec, mesh, coords, rules)),
        api.model.param_specs())


class ModelShards:
    """The train step's view of its params over a pod's (data, model)
    ranks: which leaves are split over ``model`` (``split``) and over
    ``data`` (``data``), and the two per-leaf reductions over the pod's
    ``mesh.LOCAL`` group that make a rank's numbers the whole model's.
    A leaf's block holds the same bits on every rank that holds that
    block, so each block is counted once: a leaf whole over ``model``
    gets the whole gradient on every model rank, from whole tensors (a
    gathered sequence entering whole weights, ``TP.enter``; the summed
    gradient of a share, ``copy_to_model``), or, for the norms that run
    on a rank's sequence block under a sequence split, from the step's
    one f32 sum of their gradients over the model group
    (``_norms_sum``); a data block's comes from the reduce-scatter
    (``sharding.fsdp``)."""

    def __init__(self, api: ModelAPI, mesh, staging=None, rules=None):
        ax = rank_axes(mesh)
        split = split_axes(api, mesh, rules)
        self.split = [("model" in a) for a in split]
        self.data = [("data" in a) for a in split]
        self.index = (ax.index("data"), ax.index("model"))
        self.group = ax.group(LOCAL)
        self.staging = staging or RK.Staging()

    def leaf_totals(self, sums: torch.Tensor) -> torch.Tensor:
        """Each leaf's sum of squares over the whole leaf, from this
        rank's [n] vector: summed over the group, each leaf counted once
        along every axis that does not split it (the ranks off index 0 of
        such an axis add zeros, so the sum is exact)."""
        d, j = self.index
        keep = (torch.tensor(self.split, device=sums.device) | (j == 0)) \
            & (torch.tensor(self.data, device=sums.device) | (d == 0))
        total = torch.where(keep, sums, torch.zeros_like(sums))
        return RK.all_reduce(self.staging, total, self.group,
                             tag="grad_norm")

    def leaf_absmax(self, absmax: torch.Tensor) -> torch.Tensor:
        """Each leaf's largest |value| over the whole leaf: the max over
        the group of this rank's [n] vector."""
        return RK.all_reduce(self.staging, absmax.contiguous(), self.group,
                             tag="absmax", op="max")


class DataLayout:
    """A params-shaped tree's blocks over the data axis of a mesh of ranks
    (params, or one of AdamW's states), and the whole leaves they come
    from: what a checkpoint writes and restores (whole host arrays, the
    reference's format)."""

    def __init__(self, api: ModelAPI, mesh, rules=None):
        self.api = api
        dax, self.dims = _data_blocks(api, mesh, rules)
        # a staging of its own: a checkpoint's gathers are not a step's
        self.blocks = None if dax is None else FS.DataBlocks(
            dataclasses.replace(dax, staging=RK.Staging()), self.dims)
        self.cuts = param_blocks(api, mesh, rules=rules)

    def whole(self, tree):
        """Each leaf gathered whole over the data group onto the host, one
        at a time (every rank of the group takes part)."""
        if self.blocks is None:
            return tree
        with torch.no_grad():
            return map_tree(lambda t, d: FS.gather_data(
                t, d, self.blocks).cpu(), tree, self.dims)

    def like(self, tree):
        """``TensorSpec``s of the whole leaves of ``tree``'s blocks, on the
        host in their dtypes (what ``CheckpointManager.restore`` reads)."""
        from repro_torch.checkpoint.manager import TensorSpec
        return map_tree(lambda t, sp: TensorSpec(tuple(sp.shape), t.dtype,
                                                 "cpu"),
                        tree, self.api.param_specs())

    def cut(self, whole, like):
        """This rank's blocks of the whole host tree ``whole``, each on
        the device of ``like``'s leaf."""
        cuts = iter(self.cuts)

        def one(w, t):
            b = next(cuts)
            return (w if b is None else w[b]).to(t.device, copy=True)

        return map_tree(one, whole, like)


def check_shards(api: ModelAPI, mesh, params, what: str,
                 rules=None) -> None:
    """Refuse, by name, params that are not this rank's blocks."""
    blocks = iter(param_blocks(api, mesh, rules=rules))

    def check(t, spec):
        blk = next(blocks)
        want = tuple(spec.shape) if blk is None else tuple(
            len(range(n)[b]) for b, n in zip(blk, spec.shape))
        if tuple(t.shape) != want:
            raise ValueError(
                f"{what}: a param of shape {tuple(t.shape)} where this "
                f"rank's block is {want} (axes {spec.axes}); on a mesh of "
                f"ranks pass shard_params(api, mesh, params)")

    map_tree(check, params, api.param_specs())


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def batch_to_device(batch: Dict[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Host arrays (numpy) onto ``device`` in their own dtypes, through
    pinned memory on a card so the copy does not wait for queued work;
    tensors already there pass as they are."""
    return {k: v if isinstance(v, torch.Tensor) and v.device == device
            else to_device(v, device, np.asarray(v).dtype)
            for k, v in batch.items()}


def _rank_rows(mesh, axes, n: int, what: str = "train_step"
               ) -> Tuple[int, int]:
    """(this rank's index, the rank count) over ``axes`` of ``mesh``,
    pod-major: the reference's batch sharding gives rank (p, d) the
    ``(p * data + d)``-th block of ``n / count`` rows."""
    ax = rank_axes(mesh)
    idx, count = 0, 1
    for a in axes:
        idx, count = idx * ax.size(a) + ax.index(a), count * ax.size(a)
    if n % count:
        raise ValueError(f"{what}: global batch {n} does not split "
                         f"over {count} ranks of {axes}")
    return idx, count


def _label_counts(batch, count: int) -> np.ndarray:
    """Unmasked labels in each of ``count`` row blocks of the global
    batch, from the host arrays every rank holds (no collective)."""
    labels = batch["labels"]
    B, S = tuple(np.shape(labels))
    mask = batch.get("label_mask")
    if mask is None:
        return np.full(count, B // count * S, np.float64)
    m = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) \
        else np.asarray(mask)
    return m.reshape(count, -1).astype(np.float64).sum(axis=1)


def _weighted_sum(staging, trees, weight: torch.Tensor, group):
    """``sum over group of weight * tree`` for each tree (f32, one
    collective for all of them); leaves return in their own dtypes."""
    flat_in = [t for tree in trees for t in leaves(tree)]
    flat = torch.cat([t.float().reshape(-1) for t in flat_in]).mul_(weight)
    RK.all_reduce(staging, flat, group, tag="weighted_sum")
    parts = iter(p.reshape(t.shape).to(t.dtype) for p, t in
                 zip(flat.split([t.numel() for t in flat_in]), flat_in))
    return [map_tree(lambda _: next(parts), tree) for tree in trees]


def _norms_sum(staging, flat: List[torch.Tensor], mask: List[bool],
               group) -> List[torch.Tensor]:
    """``flat`` with each gradient where ``mask`` holds summed over
    ``group`` (the model group) in f32, one collective for all of them,
    each rounded once to its dtype: the same bits on every rank."""
    parts = [g for g, m in zip(flat, mask) if m]
    total = torch.cat([g.float().reshape(-1) for g in parts])
    RK.all_reduce(staging, total, group, tag="norms_sum")
    it = iter(t.reshape(g.shape).to(g.dtype) for t, g in
              zip(total.split([g.numel() for g in parts]), parts))
    return [next(it) if m else g for g, m in zip(flat, mask)]


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, shape: ShapeConfig,
                    *, device: Optional[Union[str, torch.device]] = None,
                    mesh=None, act_rules=None, param_rules=None,
                    compress_pod_grads: bool = False):
    """``train_step(params, opt_state, batch, step) -> (loss, params,
    opt_state, gnorm)``: the loss and its gradient by autograd, then
    ``adamw.update``. ``params`` and ``opt_state`` are updated in place
    (the reference donates them) and returned; ``loss`` and ``gnorm`` are
    0-d f32 tensors on the device, not read back. ``batch`` holds
    ``tokens`` and ``labels`` [global_batch, seq_len] (and optionally
    ``label_mask``), host arrays or tensors on the device. ``device``
    defaults to ``cuda`` and must be the model's. ``mesh`` (the
    reference's argument, here by keyword) is checked by ``check_mesh``
    and the loss runs under its ``act_rules``; ``param_rules`` (default
    ``PARAM_RULES``, checked by ``check_param_rules``) places the params
    on a mesh of ranks and nothing on one device. On a mesh of ranks each
    rank runs this on its rows and the step reduces across ranks (see the
    module's docstring); ``params`` and ``opt_state`` are this rank's
    blocks (``shard_params`` or ``draw_params``, then ``adamw.init``;
    whole ones raise by name where a leaf is split) and so are the
    returned ones. With ``compress_pod_grads`` on a mesh of ranks with a
    ``pod`` axis the step is the compressed one: ``train_step(params,
    opt_state, ef, batch, step) -> (loss, params, opt_state, ef,
    gnorm)``, ``ef`` from ``optim.compression.init_error_feedback`` (of
    the blocks). The step's ``staging`` attribute (a
    ``launch.ranks.Staging``) counts the bytes its data reduce of whole
    leaves, pod sums and pod exchange messaged, ``model_staging`` (None
    without a model axis) those of the model axis's collectives,
    ``gather_staging`` and ``scatter_staging`` (None without a data axis)
    those of the data axis's gathers and reduce-scatters. Under a
    sequence split (``act_rules`` splitting ``shape.seq_len`` over
    ``model``, ``TP.seq_splits``) ``seq_gather_staging`` and
    ``seq_scatter_staging`` count the sequence's gathers and
    reduce-scatters (apart from ``model_staging``) and
    ``norms_staging`` the norms' sum over the model group; None
    without one.
    """
    dev = resolve_device(device)
    if dev != api.device:
        raise ValueError(f"make_train_step: device {dev} but the model is "
                         f"on {api.device}")
    pods = mesh is not None and "pod" in R.mesh_axis_sizes(mesh)
    if compress_pod_grads and pods and not R.is_device_mesh(mesh):
        raise NotImplementedError(
            "make_train_step(compress_pod_grads=True): the int8 "
            "error-feedback exchange (optim/compression.py) runs between "
            "ranks, one a pod; a logical mesh in a process of one rank has "
            "no pods to exchange with (ROADMAP queue 1, item 10)")
    check_mesh(api, mesh, "make_train_step")
    check_param_rules(api, mesh, param_rules, "make_train_step")
    act_rules = act_rules or R.ACT_RULES
    on_card = dev.type == "cuda"
    if on_card:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    want = (shape.global_batch, shape.seq_len)
    ranked = R.is_device_mesh(mesh)
    compressed = compress_pod_grads and pods and ranked
    tp = TP.axis_of(mesh)
    staging = RK.Staging()      # host buffers of this step's messages
    dax, dims = _data_blocks(api, mesh, param_rules)
    shards = ModelShards(api, mesh, staging, param_rules) \
        if tp is not None or dax is not None else None
    # the leaves whole over data: their gradient joins the weighted sum
    whole = None if dims is None else [d is None for d in leaves(dims)]
    # under a sequence split, the norms' gradients: a block's share a rank
    seq = TP.seq_splits(mesh, act_rules, shape.seq_len)
    norms = [n in api.model.seq_norms()
             for n in named_leaves(api.param_specs())] if seq else None
    norms_staging = RK.Staging() if seq else None
    if ranked:
        ax = rank_axes(mesh)
        # plain: every (pod, data) position one share; compressed: shares
        # within a pod; the model ranks of a position share its rows
        share_axes = ("data",) if compressed else ROWS
        idx, count = _rank_rows(mesh, ROWS, shape.global_batch)
        share, shares = _rank_rows(mesh, share_axes, shape.global_batch)
        share_group = ax.group("data") if compressed else \
            ax.group(ROWS) if tp is not None else None
        # a data block's gradient: the data group's reduce-scatter, then
        # (plain) the pods' sum
        pod_sum = (ax.group("pod"), staging) if dax is not None \
            and not compressed and ax.size("pod") > 1 else None
        # the rows an MoE layer routes over: the shares' (the whole batch,
        # or the pod's in the compressed step, as its shard_map over pod)
        row_blocks = FS.RowBlocks(share, shares, share_group, staging) \
            if shares > 1 else None

    def loss_and_grad(params, batch):
        if tuple(np.shape(batch["tokens"])) != want:
            raise ValueError(f"train_step: tokens {np.shape(batch['tokens'])}"
                             f" but the step's shape is {want}")
        weight = None
        if ranked and shares > 1:
            counts = _label_counts(batch, count)
            if compressed:       # this pod's blocks, in data order
                pod = ax.index("pod")
                counts = counts[pod * shares:(pod + 1) * shares]
            weight = torch.tensor(counts[share] / max(counts.sum(), 1.0),
                                  dtype=torch.float32, device=dev)
        if ranked:
            rows = slice(idx * (want[0] // count),
                         (idx + 1) * (want[0] // count))
            batch = {k: v[rows] for k, v in batch.items()}
        b = batch_to_device(batch, dev)
        tracked = map_tree(lambda p: p.detach().requires_grad_(), params)
        data = None if dax is None else FS.DataBlocks(dax, dims, weight,
                                                      pod_sum)
        with torch.enable_grad(), R.axis_rules(
                mesh, act_rules, data, row_blocks if ranked else None):
            loss = api.loss_fn(_gathered(api, tracked, dims), b)
            flat = list(torch.autograd.grad(loss, leaves(tracked)))
        loss = loss.detach()
        if norms is not None:
            flat = _norms_sum(norms_staging, flat, norms, tp.group)
        if weight is not None:
            keep = [g for k, g in enumerate(flat) if whole is None
                    or whole[k]]
            loss, keep = _weighted_sum(staging, [loss, keep], weight,
                                       share_group)
            it = iter(keep)
            flat = [next(it) if whole is None or whole[k] else g
                    for k, g in enumerate(flat)]
        it = iter(flat)
        return loss, map_tree(lambda _: next(it), tracked)

    def step_tensor(step):
        return step.to(dev, torch.float32).reshape(()) \
            if isinstance(step, torch.Tensor) else to_device(
                np.asarray(step, np.float32), dev, np.float32).reshape(())

    def check(params, opt_state):
        if ranked:
            check_shards(api, mesh, params, "train_step", param_rules)
            check_shards(api, mesh, opt_state.master, "train_step",
                         param_rules)

    def train_step(params, opt_state, batch, step):
        check(params, opt_state)
        step_t = step_tensor(step)
        with deterministic(on_card):
            loss, grads = loss_and_grad(params, batch)
            params, opt_state, gnorm = adamw.update(
                opt_cfg, grads, opt_state, step_t, params=params,
                leaf_totals=shards and shards.leaf_totals)
        return loss, params, opt_state, gnorm

    _train_stagings(train_step, staging, tp, dax, norms_staging)
    if not compressed:
        return train_step
    num_pods = ax.size("pod")
    pod_group = ax.group("pod")

    def train_step_compressed(params, opt_state, ef, batch, step):
        check(params, opt_state)
        step_t = step_tensor(step)
        with deterministic(on_card):
            loss, grads = loss_and_grad(params, batch)
            grads, ef = compressed_psum_pod(
                grads, ef, pod_group, num_pods, staging,
                leaf_absmax=shards and shards.leaf_absmax)
            # pmean: XLA folds its / num_pods into a multiply by 1/num_pods
            RK.all_reduce(staging, loss, pod_group, tag="pod_loss")
            loss = loss * torch.full((), 1.0 / num_pods, device=dev)
            # new params take the reduced gradient's dtype (f32), as the
            # reference's update casts its master copy to each grad's
            same = all(p.dtype == g.dtype
                       for p, g in zip(leaves(params), leaves(grads)))
            params, opt_state, gnorm = adamw.update(
                opt_cfg, grads, opt_state, step_t,
                params=params if same else None,
                leaf_totals=shards and shards.leaf_totals)
        return loss, params, opt_state, ef, gnorm

    _train_stagings(train_step_compressed, staging, tp, dax, norms_staging)
    return train_step_compressed


def _data_blocks(api: ModelAPI, mesh, rules):
    """(this rank's ``DataAxis``, ``data_dims``) where some leaf is split
    over the data axis of a mesh of ranks, else (None, None)."""
    dax = FS.axis_of(mesh)
    if dax is None:
        return None, None
    dims = data_dims(api, mesh, rules)
    if all(d is None for d in leaves(dims)):
        return None, None
    return dax, dims


def _gathered(api: ModelAPI, params, dims):
    """What a step hands the model: its params as they are for a
    ``StackedLM``, which gathers each leaf where it is used
    (``sharding.fsdp``), else (Whisper) every leaf gathered whole now."""
    if dims is None or isinstance(api.model, StackedLM):
        return params
    return FS.gather_leaves(params, dims)


def _train_stagings(step, staging, tp, dax, norms_staging) -> None:
    """A train step's ``Staging`` attributes (see ``make_train_step``)."""
    step.staging = staging
    step.model_staging = tp.staging if tp is not None else None
    step.gather_staging = dax.staging if dax is not None else None
    step.scatter_staging = dax.scatter if dax is not None else None
    seq = norms_staging is not None
    step.seq_gather_staging = tp.seq_gather if seq else None
    step.seq_scatter_staging = tp.seq_scatter if seq else None
    step.norms_staging = norms_staging


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
def _check_inputs(api: ModelAPI, shape: ShapeConfig, batch, what: str):
    for k, (shp, _) in api.input_specs(shape).items():
        got = tuple(batch[k].shape) if k in batch else None
        if got != tuple(shp):
            raise ValueError(f"{what}: {k} {got} but the step's shape "
                             f"{shape.name} gives {tuple(shp)}")


class _RankRows:
    """A serve step's rows on a mesh of ranks: rank (p, d) takes the
    ``(p * data + d)``-th block of ``B / (pod * data)`` rows of the global
    batch (``act_batch`` over ``("pod", "data")``, the block order of the
    train step's ``_rank_rows``). By default the whole [B, V] logits come
    back on every rank (the reference's replicated logits), gathered over
    its ``data`` group and then its ``pod`` group, so in block order; the
    ranks of a ``model`` group hold the same rows and the same logits.
    With ``sharded`` each rank returns its block of ``("act_batch",
    "act_vocab")`` resolved under ``act_rules`` (the reference's
    ``_logits_sharding``): its own rows, and its vocab block where the
    vocab splits over ``model`` (``keep()``: the head's columns are not
    gathered), so nothing crosses a rank for the logits. Nothing on one
    device or a logical mesh."""

    def __init__(self, api: ModelAPI, mesh, B: int, what: str, act_rules,
                 sharded: bool):
        self.on = _on_ranks(mesh)
        self.keep_rows = self.keep_vocab = False
        if not self.on:
            return
        idx, count = _rank_rows(mesh, ("pod", "data"), B, what)
        b = B // count
        self.rows = slice(idx * b, (idx + 1) * b)
        ax = rank_axes(mesh)
        self.groups = [ax.group(a) for a in ("data", "pod")
                       if ax.size(a) > 1]
        self.staging = RK.Staging()
        if not sharded:
            return
        V = api.cfg.vocab_size
        sh = R.logical_sharding((B, V), ("act_batch", "act_vocab"), mesh,
                                act_rules)
        rows, cols = sh.block((B, V), ax.coords)
        vocab = _split_dims((B, V), ("act_batch", "act_vocab"), mesh,
                            act_rules).get("model")
        if rows not in (self.rows, slice(None)) or (
                cols != slice(None) and vocab != 1):
            raise NotImplementedError(
                f"{what}: sharded_logits resolve to {sh.spec} under "
                f"act_rules; the ranks hold rows over (pod, data) and the "
                f"vocab over model (ROADMAP item 10d, step 5c)")
        self.keep_rows = rows == self.rows
        self.keep_vocab = vocab == 1

    def take(self, batch):
        if not self.on:
            return batch
        return {k: v[self.rows] for k, v in batch.items()}

    def keep(self):
        """The context a step's forward runs in: a vocab-split head keeps
        its block of columns where the logits are sharded over model."""
        return TP.keep_vocab_split(self.keep_vocab)

    def logits(self, logits: torch.Tensor) -> torch.Tensor:
        if not self.on or self.keep_rows:
            return logits
        for g in self.groups:
            logits = RK.all_gather(self.staging, logits.contiguous(), g,
                                   tag="logits").reshape(-1, logits.shape[-1])
        return logits


def _serve_step(api: ModelAPI, mesh, shape: ShapeConfig, what: str,
                act_rules, param_rules, sharded_logits: bool):
    """What a serve step needs: (act_rules, ``_RankRows``, the step's rule
    context's ``data``, ``data_dims``, its stagings, whether its timeline
    cache holds the rank's block of the positions), after refusing by
    name what it does not run."""
    check_mesh(api, mesh, f"make_{what}")
    check_param_rules(api, mesh, param_rules, f"make_{what}")
    act_rules = act_rules or R.ACT_RULES
    ranks = _RankRows(api, mesh, shape.global_batch, what, act_rules,
                      sharded_logits)
    tp = TP.axis_of(mesh)
    dax, dims = _data_blocks(api, mesh, param_rules)
    data = None if dax is None else FS.DataBlocks(dax, dims)
    stagings = ([ranks.staging] if ranks.on else []) + \
        ([tp.staging, tp.seq_gather, tp.seq_scatter, tp.q_gather,
          tp.combine] if tp is not None else []) + \
        ([dax.staging] if dax is not None else [])
    positions = shape.seq_len if TP.kv_seq_splits(
        mesh, act_rules, api.cfg.num_kv_heads, shape.seq_len) else 0
    return act_rules, ranks, data, dims, stagings, positions


def keep_positions(api: ModelAPI, cache):
    """``cache`` (a timeline cache tree of whole positions) with every KV
    leaf narrowed to this rank's block of its positions along
    ``act_kv_seq`` (``TP.positions_split``), as new tensors; the cache
    itself where the positions are whole."""
    ax = TP.positions_split()
    if ax is None:
        return cache
    from repro_torch.runtime.pipeline import axes_leaves
    out = dict(cache)
    for seg in api.model.segments:
        axes = iter(axes_leaves(api.model.init_cache_axes()[seg.name]))

        def cut(t):
            ax_names = next(axes)
            if "act_kv_seq" not in ax_names:
                return t
            d = ax_names.index("act_kv_seq")
            n = t.shape[d] // ax.size
            # the whole horizon that kv_positions gave, cut in M blocks
            assert n * ax.size == t.shape[d] == TP.whole_positions(n), \
                (t.shape, d)
            return t.narrow(d, ax.index * n, n).clone()

        out[seg.name] = map_tree(cut, cache[seg.name])
    return out


def _positions_stagings(step, tp) -> None:
    """A serve step's flash-decode stagings (None without a model axis)."""
    step.q_gather_staging = tp and tp.q_gather
    step.combine_staging = tp and tp.combine


def make_prefill_step(api: ModelAPI, mesh, shape: ShapeConfig, *,
                      act_rules=None, param_rules=None,
                      sharded_logits: bool = False):
    """``prefill_step(params, batch) -> (logits, cache)``: ``api.prefill_fn``
    under ``act_rules`` on ``mesh`` (checked by ``check_mesh``), nothing
    else: the step adds no arithmetic. ``batch`` holds tensors on the
    model's device with ``input_specs(shape)``'s shapes. On a mesh of
    ranks each rank runs its block of the batch's rows (``_RankRows``; a
    batch that does not split over the ranks raises by name) and returns
    the whole [B, V] logits (with ``sharded_logits``, its block of them)
    and the cache of its rows only, as ``act_kv_batch`` shards it;
    ``params`` are the rank's blocks under ``param_rules`` (default
    ``PARAM_RULES``, checked by ``check_param_rules``; ``shard_params``,
    others raise by name where a leaf is split), gathered over data where
    they are used (``sharding.fsdp``), and over a ``model`` axis the
    cache holds the rank's KV heads where they divide over ``model``,
    else all of them. On one device ``param_rules``
    and ``sharded_logits`` place nothing. ``prefill_step.stagings`` are
    the step's ``Staging`` buffers; ``gather_staging`` (None without a
    data axis) the data axis's gathers'. Where the KV heads do not divide
    over ``model`` and the prompt's positions do, the cache holds this
    rank's block of them (``keep_positions``)."""
    act_rules, ranks, data, dims, stagings, positions = _serve_step(
        api, mesh, shape, "prefill_step", act_rules, param_rules,
        sharded_logits)

    def prefill_step(params, batch):
        _check_inputs(api, shape, batch, "prefill_step")
        if ranks.on:
            check_shards(api, mesh, params, "prefill_step", param_rules)
        with R.axis_rules(mesh, act_rules, data), ranks.keep(), \
                TP.kv_positions(positions):
            logits, cache = api.prefill_fn(_gathered(api, params, dims),
                                           ranks.take(batch))
            return ranks.logits(logits), keep_positions(api, cache)

    prefill_step.stagings = stagings
    prefill_step.gather_staging = data and data.axis.staging
    prefill_step.positions = positions
    _positions_stagings(prefill_step, TP.axis_of(mesh))
    return prefill_step


def make_decode_step(api: ModelAPI, mesh, shape: ShapeConfig, *,
                     act_rules=None, param_rules=None,
                     sharded_logits: bool = False):
    """``decode_step(params, cache, batch) -> (logits, cache)``:
    ``api.decode_fn`` under ``act_rules`` on ``mesh``; the cache (a
    timeline cache of ``shape.seq_len`` positions) is updated in place and
    returned, as the reference donates it. On a mesh of ranks ``batch``
    is the global batch and ``cache`` this rank's rows (the prefill
    step's), ``params`` its blocks, as ``make_prefill_step``, and over a
    ``model`` axis its KV heads, or (KV heads that do not divide, a
    horizon that does) its block of the positions, over which it runs
    the distributed flash-decode; the logits are the whole [B, V] (with
    ``sharded_logits``, the rank's block)."""
    act_rules, ranks, data, dims, stagings, positions = _serve_step(
        api, mesh, shape, "decode_step", act_rules, param_rules,
        sharded_logits)

    def decode_step(params, cache, batch):
        _check_inputs(api, shape, batch, "decode_step")
        if ranks.on:
            check_shards(api, mesh, params, "decode_step", param_rules)
        with R.axis_rules(mesh, act_rules, data), ranks.keep(), \
                TP.kv_positions(positions):
            logits, cache = api.decode_fn(_gathered(api, params, dims),
                                          cache, ranks.take(batch))
            return ranks.logits(logits), cache

    decode_step.stagings = stagings
    decode_step.gather_staging = data and data.axis.staging
    decode_step.positions = positions
    _positions_stagings(decode_step, TP.axis_of(mesh))
    return decode_step


def abstract_inputs(api: ModelAPI, shape: ShapeConfig, mesh=None,
                    param_rules=None,
                    coords: Optional[Dict[str, int]] = None
                    ) -> Dict[str, Any]:
    """Meta tensors for (params, [opt], batch, [cache]), the dry-run's
    stand-ins: the params in the model's dtype, the AdamW state in f32 for
    ``train``, a timeline cache of ``shape.seq_len`` positions for
    ``decode``. With ``mesh`` (of ranks, or any mesh with ``coords``) the
    params and the AdamW state are the blocks that rank holds
    (``param_blocks`` under ``param_rules``). They hold no memory."""
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    params = api.abstract_params()
    if mesh is not None:
        blocks = iter(param_blocks(api, mesh, coords, param_rules))

        def cut(t):
            b = next(blocks)
            return t if b is None else meta(t[b].shape, t.dtype)

        params = map_tree(cut, params)
    batch = {k: meta(shp, dt) for k, (shp, dt) in
             api.input_specs(shape).items()}
    out = {"params": params, "batch": batch}
    if shape.kind == "train":
        f32 = lambda: map_tree(lambda p: meta(p.shape, torch.float32),
                               params)
        out["opt"] = AdamWState(f32(), f32(), f32())
    if shape.kind == "decode":
        out["cache"] = map_specs(lambda s: meta(*s), api.init_cache_specs(
            shape.global_batch, shape.seq_len))
    return out
