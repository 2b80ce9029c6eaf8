"""Step builders of the port (``repro/runtime/steps.py``): the train step,
the prefill and decode serve steps, their sharding trees and
``abstract_inputs``, the stand-ins the dry-run counts.

The sharding trees (``param_shardings``, ``opt_shardings``,
``batch_shardings``, ``cache_shardings``) resolve every leaf's logical
axes on a mesh (``repro_torch.sharding``), a ``DeviceMesh`` or a logical
one. The steps run on one device: with no mesh or on a mesh of one, the
tensors stay plain tensors on the model's device, so the hand-written
kernels (launched through ctypes, which a DTensor would not reach) run as
they do everywhere else. On the meta device a step runs over a logical
mesh of any size, placing nothing: the dry-run counts it. A mesh of more
than one device on a real device needs DTensor execution over several
ranks, and the compressed cross-pod train step needs pods of cards; both
are refused by name (ROADMAP item 10).

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
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import is_spec, map_specs
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
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


def check_mesh(api: ModelAPI, mesh, what: str) -> None:
    """The meshes a step of the port runs over: none, a mesh of one
    device (a ``DeviceMesh`` on the model's device type, or a logical
    one), or any logical mesh when the model is on ``meta``, where nothing
    is placed. Anything else raises by name."""
    if mesh is None:
        return
    n = R.mesh_size(mesh)
    if R.is_device_mesh(mesh) and mesh.device_type != api.device.type:
        raise ValueError(f"{what}: mesh on {mesh.device_type} but the "
                         f"model is on {api.device}")
    if n == 1 or api.device.type == "meta":
        return
    raise NotImplementedError(
        f"{what}: a mesh of {n} devices {R.mesh_axis_sizes(mesh)} would "
        f"place tensors over several ranks as DTensors; the port runs on "
        f"one card, or counts on meta tensors (ROADMAP queue 1, item 10)")


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


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, shape: ShapeConfig,
                    *, device: Optional[Union[str, torch.device]] = None,
                    mesh=None, act_rules=None, param_rules=None,
                    compress_pod_grads: bool = False):
    """``train_step(params, opt_state, batch, step) -> (loss, params,
    opt_state, gnorm)``: the loss and its gradient by autograd, then
    ``adamw.update``. ``params`` and ``opt_state`` are updated in place
    (the reference donates them) and returned; ``loss`` and ``gnorm`` are
    0-d f32 tensors on the device, not read back. ``batch`` holds
    ``tokens`` and ``labels`` [global_batch, seq_len], host arrays or
    tensors on the device. ``device`` defaults to ``cuda`` and must be the
    model's. ``mesh`` (the reference's argument, here by keyword) is
    checked by ``check_mesh`` and the loss runs under its ``act_rules``;
    ``param_rules`` is the reference's and places nothing on one device.
    ``compress_pod_grads`` on a mesh with pods is refused by name."""
    del param_rules
    dev = resolve_device(device)
    if dev != api.device:
        raise ValueError(f"make_train_step: device {dev} but the model is "
                         f"on {api.device}")
    if compress_pod_grads and mesh is not None \
            and "pod" in R.mesh_axis_sizes(mesh):
        raise NotImplementedError(
            "make_train_step(compress_pod_grads=True): the int8 "
            "error-feedback exchange (optim/compression.py) exists only "
            "across pods of cards (ROADMAP queue 1, item 10)")
    check_mesh(api, mesh, "make_train_step")
    act_rules = act_rules or R.ACT_RULES
    on_card = dev.type == "cuda"
    if on_card:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    want = (shape.global_batch, shape.seq_len)

    def train_step(params, opt_state, batch, step):
        if tuple(np.shape(batch["tokens"])) != want:
            raise ValueError(f"train_step: tokens {np.shape(batch['tokens'])}"
                             f" but the step's shape is {want}")
        b = batch_to_device(batch, dev)
        step_t = step.to(dev, torch.float32).reshape(()) \
            if isinstance(step, torch.Tensor) else to_device(
                np.asarray(step, np.float32), dev, np.float32).reshape(())
        with deterministic(on_card):
            tracked = map_tree(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad(), R.axis_rules(mesh, act_rules):
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
