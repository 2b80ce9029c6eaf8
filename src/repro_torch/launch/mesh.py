"""Mesh construction (the port of ``repro/launch/mesh.py``).

``make_mesh(shape, axes)`` gives a ``torch.distributed`` ``DeviceMesh``
where the process group has as many ranks as the mesh has devices: on one
card with no group that is a mesh of one, over a one-rank process group
that ``make_mesh`` sets up itself (an in-process store: no address, no
network); in a rank that ``launch.ranks.spawn`` started, a mesh of the
world's ranks, pod-major (rank ``p * data + d`` is pod p, data index d),
with one process group per axis (``rank_axes``; with a ``model`` axis
above 1 also the group of the ranks that share this rank's model index,
``ROWS``, and with ``data`` or ``model`` above 1 the group of this pod's
(data, model) ranks, ``LOCAL``). Any other mesh, the
production meshes among them, is a ``LogicalMesh``: axis names and sizes,
no devices. The sharding rules and the dry-run read a logical mesh; a
step that would have to place tensors on one refuses it by name (ROADMAP
item 10).
``make_production_mesh`` is a function, as in the reference, so importing
this module touches no device state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes of a mesh with no devices behind it."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} vs axes "
                             f"{self.axis_names}")


def _one_rank_group(device: torch.device) -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: Optional[Union[str, torch.device]] = None):
    """A mesh of ``shape`` over ``axes`` (e.g. ``(2, 2)`` x ``('pod',
    'data')``). A real ``DeviceMesh`` on ``device`` (default ``cuda``;
    raises without a card) when the process group has as many ranks as
    the mesh has devices, or the mesh has one device; else a
    ``LogicalMesh``."""
    import torch.distributed as dist
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    n = math.prod(shape)
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if n != ranks:
        return LogicalMesh(shape, axes)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the process's card before its communicator starts
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    _one_rank_group(dev)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


# the (pod, data) ranks of one model index: the data axes' reduce
ROWS = ("pod", "data")
# the (data, model) ranks of one pod: a whole leaf's norm and absmax from
# its blocks
LOCAL = ("data", "model")
# (mesh id, axes) -> (the mesh, this rank's group of those axes); made
# once a mesh, by every rank together
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any]] = {}


@dataclasses.dataclass(frozen=True)
class RankAxes:
    """This rank's place on a mesh of ranks: its coordinate and the
    process group along each axis (the ranks that differ from it on that
    axis only). An axis the mesh lacks has size 1, index 0, no group.
    With a ``model`` axis above 1 and more than one (pod, data) position,
    ``group(ROWS)`` is the group of the ranks that hold this rank's model
    index (its pod and data neighbours together). With ``data`` or
    ``model`` above 1, ``group(LOCAL)`` is the group of this pod's (data,
    model) ranks (the data or model group where the other is 1)."""

    coords: Dict[str, int]
    sizes: Dict[str, int]
    groups: Dict[str, Any]

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def group(self, axis: str):
        return self.groups.get(axis)


def rank_axes(mesh) -> RankAxes:
    """``RankAxes`` of this process on a ``DeviceMesh``."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank_axes: this rank is not on {mesh}")
    sizes = dict(zip(names, tuple(mesh.mesh.shape)))
    groups = {n: mesh.get_group(n) for n in names}
    rows = math.prod(sizes.get(a, 1) for a in ROWS)
    if sizes.get("model", 1) > 1 and rows > 1:
        groups[ROWS] = _axes_group(mesh, names, ROWS)
    wide = [a for a in LOCAL if sizes.get(a, 1) > 1]
    if len(wide) == 2:
        groups[LOCAL] = _axes_group(mesh, names, LOCAL)
    elif wide:
        groups[LOCAL] = groups[wide[0]]
    return RankAxes(dict(zip(names, (int(c) for c in coord))), sizes,
                    groups)


def _axes_group(mesh, names, axes: Tuple[str, ...]):
    """This rank's group of the ranks that differ from it on ``axes``
    only (each group's ranks in mesh order), made once a mesh: every
    rank makes every such group, in the order of the other axes'
    coordinates."""
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist
    inner = [names.index(a) for a in axes if a in names]
    outer = [d for d in range(len(names)) if d not in inner]
    ranks = mesh.mesh.permute(*outer, *inner).reshape(
        -1, math.prod(mesh.mesh.shape[d] for d in inner))
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    _GROUPS[key] = (mesh, group)
    return group


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips): always
    logical here."""
    if multi_pod:
        return LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    return LogicalMesh((16, 16), ("data", "model"))


def mesh_context(mesh):
    """A no-op context, as the reference's is on a jax without an ambient
    mesh: every step builder threads its mesh explicitly."""
    del mesh
    return contextlib.nullcontext()
