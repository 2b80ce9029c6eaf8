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
drawn from ``pod`` and ``data``, a ``model`` axis of 1. Each rank holds
plain tensors, takes its rows of the global batch (pod-major, as the
reference's batch sharding lays them out) and reduces with explicit
collectives on the process group of an axis (``launch.ranks``). The plain
step averages the gradient and the loss over every rank, each rank
weighted by its count of unmasked labels, so a ``label_mask`` that gives
the ranks unequal counts still gives the batch's mean. The compressed
step (``compress_pod_grads``, the reference's ``_make_train_step_compressed``)
averages within a pod over its ``data`` group the same way, exchanges the
pod's gradient as int8 with error feedback over ``pod``
(``optim.compression``) and takes the pods' mean loss. A ``model`` axis
above 1 (tensor parallelism), the serve steps over ranks and a logical
mesh of several devices in a process of one rank are refused by name
(ROADMAP item 10d and item 10).

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
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.launch import ranks as RK
from repro_torch.launch.mesh import rank_axes
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import is_spec, map_specs
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.optim.compression import compressed_psum_pod
from repro_torch.sharding import rules as R
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


def check_mesh(api: ModelAPI, mesh, what: str, ranks: bool = False
               ) -> None:
    """The meshes a step of the port runs over: none, a mesh of one
    device (a ``DeviceMesh`` on the model's device type, or a logical
    one), any logical mesh when the model is on ``meta``, where nothing
    is placed, and, for a step that takes ``ranks=True`` (the train
    steps), a ``DeviceMesh`` of the world's ranks over ``pod`` and
    ``data`` with any ``model`` axis of 1. Anything else raises by name."""
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
        if not ranks:
            raise NotImplementedError(
                f"{what}: a mesh of {n} ranks {sizes}: the serve steps run "
                f"on one device; serving over pod ranks is the engine "
                f"(ServingEngine(mesh=), serving/ranked.py) and the "
                f"pipelined decoder (runtime/pipeline.py, mesh=); the serve "
                f"steps over data ranks are ROADMAP queue 1, item 10d")
        wide = {a: k for a, k in sizes.items()
                if a not in ("pod", "data") and k > 1}
        if wide:
            raise NotImplementedError(
                f"{what}: mesh axes {wide} would be tensor parallelism "
                f"(the constrain call sites); ranks run over pod and data "
                f"only (ROADMAP queue 1, item 10d)")
        return
    raise NotImplementedError(
        f"{what}: a logical mesh of {n} devices {sizes} in a process of "
        f"one rank places nothing; run one rank per device "
        f"(launch/ranks.py) or count on meta tensors (ROADMAP queue 1, "
        f"item 10)")


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


def _rank_rows(mesh, axes, n: int) -> Tuple[int, int]:
    """(this rank's index, the rank count) over ``axes`` of ``mesh``,
    pod-major: the reference's batch sharding gives rank (p, d) the
    ``(p * data + d)``-th block of ``n / count`` rows."""
    ax = rank_axes(mesh)
    idx, count = 0, 1
    for a in axes:
        idx, count = idx * ax.size(a) + ax.index(a), count * ax.size(a)
    if n % count:
        raise ValueError(f"train_step: global batch {n} does not split "
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
    and the loss runs under its ``act_rules``; ``param_rules`` is the
    reference's and places nothing on one device. On a mesh of ranks each
    rank runs this on its rows and the step reduces across ranks (see the
    module's docstring). With ``compress_pod_grads`` on a mesh of ranks
    with a ``pod`` axis the step is the compressed one:
    ``train_step(params, opt_state, ef, batch, step) -> (loss, params,
    opt_state, ef, gnorm)``, ``ef`` from
    ``optim.compression.init_error_feedback``. The step's ``staging``
    attribute (a ``launch.ranks.Staging``) counts the bytes it messaged.
    """
    del param_rules
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
    check_mesh(api, mesh, "make_train_step", ranks=True)
    act_rules = act_rules or R.ACT_RULES
    on_card = dev.type == "cuda"
    if on_card:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    want = (shape.global_batch, shape.seq_len)
    ranked = R.is_device_mesh(mesh)
    compressed = compress_pod_grads and pods and ranked
    if ranked:
        ax = rank_axes(mesh)
        # plain: every rank one share; compressed: shares within a pod
        share_axes = ("data",) if compressed else ("pod", "data")
        idx, count = _rank_rows(mesh, ("pod", "data"), shape.global_batch)
        share, shares = _rank_rows(mesh, share_axes, shape.global_batch)
        share_group = ax.group("data") if compressed else None
    staging = RK.Staging()      # host buffers of this step's messages

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
        with torch.enable_grad(), R.axis_rules(mesh, act_rules):
            loss = api.loss_fn(tracked, b)
            flat = torch.autograd.grad(loss, leaves(tracked))
        it = iter(flat)
        grads = map_tree(lambda _: next(it), tracked)
        loss = loss.detach()
        if weight is not None:
            loss, grads = _weighted_sum(staging, [loss, grads], weight,
                                        share_group)
        return loss, grads

    def step_tensor(step):
        return step.to(dev, torch.float32).reshape(()) \
            if isinstance(step, torch.Tensor) else to_device(
                np.asarray(step, np.float32), dev, np.float32).reshape(())

    def train_step(params, opt_state, batch, step):
        step_t = step_tensor(step)
        with deterministic(on_card):
            loss, grads = loss_and_grad(params, batch)
            params, opt_state, gnorm = adamw.update(opt_cfg, grads,
                                                    opt_state, step_t,
                                                    params=params)
        return loss, params, opt_state, gnorm

    train_step.staging = staging
    if not compressed:
        return train_step
    num_pods = ax.size("pod")
    pod_group = ax.group("pod")

    def train_step_compressed(params, opt_state, ef, batch, step):
        step_t = step_tensor(step)
        with deterministic(on_card):
            loss, grads = loss_and_grad(params, batch)
            grads, ef = compressed_psum_pod(grads, ef, pod_group, num_pods,
                                            staging)
            # pmean: XLA folds its / num_pods into a multiply by 1/num_pods
            RK.all_reduce(staging, loss, pod_group, tag="pod_loss")
            loss = loss * torch.full((), 1.0 / num_pods, device=dev)
            # new params take the reduced gradient's dtype (f32), as the
            # reference's update casts its master copy to each grad's
            same = all(p.dtype == g.dtype
                       for p, g in zip(leaves(params), leaves(grads)))
            params, opt_state, gnorm = adamw.update(
                opt_cfg, grads, opt_state, step_t,
                params=params if same else None)
        return loss, params, opt_state, ef, gnorm

    train_step_compressed.staging = staging
    return train_step_compressed


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
def _check_inputs(api: ModelAPI, shape: ShapeConfig, batch, what: str):
    for k, (shp, _) in api.input_specs(shape).items():
        got = tuple(batch[k].shape) if k in batch else None
        if got != tuple(shp):
            raise ValueError(f"{what}: {k} {got} but the step's shape "
                             f"{shape.name} gives {tuple(shp)}")


def make_prefill_step(api: ModelAPI, mesh, shape: ShapeConfig, *,
                      act_rules=None, param_rules=None,
                      sharded_logits: bool = False):
    """``prefill_step(params, batch) -> (logits, cache)``: ``api.prefill_fn``
    under ``act_rules`` on ``mesh`` (checked by ``check_mesh``), nothing
    else: the step adds no arithmetic. ``batch`` holds tensors on the
    model's device with ``input_specs(shape)``'s shapes. ``param_rules``
    and ``sharded_logits`` choose the reference's output shardings, which
    place nothing on one device."""
    del param_rules, sharded_logits
    check_mesh(api, mesh, "make_prefill_step")
    act_rules = act_rules or R.ACT_RULES

    def prefill_step(params, batch):
        _check_inputs(api, shape, batch, "prefill_step")
        with R.axis_rules(mesh, act_rules):
            return api.prefill_fn(params, batch)

    return prefill_step


def make_decode_step(api: ModelAPI, mesh, shape: ShapeConfig, *,
                     act_rules=None, param_rules=None,
                     sharded_logits: bool = False):
    """``decode_step(params, cache, batch) -> (logits, cache)``:
    ``api.decode_fn`` under ``act_rules`` on ``mesh``; the cache (a
    timeline cache of ``shape.seq_len`` positions) is updated in place and
    returned, as the reference donates it."""
    del param_rules, sharded_logits
    check_mesh(api, mesh, "make_decode_step")
    act_rules = act_rules or R.ACT_RULES

    def decode_step(params, cache, batch):
        _check_inputs(api, shape, batch, "decode_step")
        with R.axis_rules(mesh, act_rules):
            return api.decode_fn(params, cache, batch)

    return decode_step


def abstract_inputs(api: ModelAPI, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors for (params, [opt], batch, [cache]), the dry-run's
    stand-ins: the params in the model's dtype, the AdamW state in f32 for
    ``train``, a timeline cache of ``shape.seq_len`` positions for
    ``decode``. They hold no memory."""
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    params = api.abstract_params()
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
