"""Logical-axis sharding rules with divisibility fallback (the port of
``repro/sharding/rules.py``).

Tensors are annotated with *logical* axis names; a rule table maps each
logical name to an ordered list of mesh-axis candidates. ``resolve_spec``
walks the candidates and picks the first assignment that (a) divides the
dimension size and (b) does not reuse a mesh axis already claimed by
another dimension of the same tensor. The rule tables and the resolution
are the reference's; a spec is a tuple with one entry a tensor dim:
``None``, one mesh axis name, or a tuple of names (a dim sharded over
several mesh axes, the first the most major), trailing ``None`` trimmed,
as the reference's ``PartitionSpec`` holds them.

``logical_sharding`` pairs a spec with its mesh as a ``NamedSharding``,
which gives the DTensor placements (one per mesh dim: ``Shard(d)`` or
``Replicate()``) and the per-device shard shape. A mesh is a
``torch.distributed`` ``DeviceMesh`` or a ``launch.mesh.LogicalMesh``
(axis names and sizes, no devices); resolution reads only the axis names
and sizes, so it runs on either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Candidate lists: tried in order; () = replicate.
Rules = Dict[Optional[str], List[Tuple[str, ...]]]

# ---------------------------------------------------------------------------
# Default rule tables (the reference's, verbatim)
# ---------------------------------------------------------------------------
# Parameters. "embed"-type dims take FSDP ("data") sharding; head/ffn/expert
# dims take tensor parallelism ("model"); vocab is tensor-sharded.
PARAM_RULES: Rules = {
    "vocab":    [("model",), ()],
    "embed":    [("data",), ()],          # ZeRO-3 / FSDP axis
    "heads":    [("model",), ()],
    "kv_heads": [("model",), ()],
    "qkv":      [("model",), ()],
    "mlp":      [("model",), ()],
    "experts":  [("model",), ()],          # expert parallelism
    "layers":   [()],                       # scan dim: never shard
    "stages":   [("pod",), ()],             # pipeline stage dim
    "conv":     [()],
    "state":    [()],
    "head_dim": [()],
    None:       [()],
}

# Activations (train / prefill).
ACT_RULES: Rules = {
    "act_batch":   [("pod", "data"), ("data",), ()],
    "act_seq":     [()],                     # SP opt-in via perf rules
    "act_embed":   [()],
    "act_heads":   [("model",), ()],
    "act_kv_heads": [("model",), ()],
    "act_mlp":     [("model",), ()],
    "act_vocab":   [("model",), ()],
    "act_experts": [("model",), ()],
    "act_kv_seq":  [("model",), ()],         # distributed flash-decode
    "act_kv_batch": [("pod", "data"), ("data",), ()],
    "act_state":   [()],
    "layers":      [()],
    None:          [()],
}

# Sequence-parallel training rules: the residual stream shards its
# sequence dim over ``model`` (Megatron-SP). Opt-in: the baseline keeps
# activations unsharded.
SP_ACT_RULES: Rules = dict(ACT_RULES)
SP_ACT_RULES["act_seq_sp"] = [("model",), ()]
ACT_RULES = dict(ACT_RULES)
ACT_RULES["act_seq_sp"] = [()]

# Rules for the body of the pipelined serve: the ``pod`` axis is manual
# (pipeline stages), so activation/cache rules may only use data/model.
PIPE_RULES: Rules = {
    "act_batch":   [("data",), ()],
    "act_seq":     [()],
    "act_embed":   [()],
    "act_heads":   [("model",), ()],
    "act_kv_heads": [("model",), ()],
    "act_mlp":     [("model",), ()],
    "act_vocab":   [("model",), ()],
    "act_experts": [("model",), ()],
    "act_kv_seq":  [("model",), ()],
    "act_kv_batch": [("data",), ()],
    "act_state":   [()],
    "act_seq_sp":  [()],
    "layers":      [()],
    None:          [()],
}


def merge_rules(base: Rules, override: Rules) -> Rules:
    out = dict(base)
    out.update(override)
    return out


# ---------------------------------------------------------------------------
# Meshes: names and sizes
# ---------------------------------------------------------------------------
def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``LogicalMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


def is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------
Spec = Tuple[Any, ...]


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh, rules: Rules) -> Spec:
    """Map logical axes -> a partition spec honoring divisibility and
    axis reuse (the reference's ``resolve_spec``)."""
    if len(shape) != len(axes):
        raise ValueError(f"rank mismatch: shape {tuple(shape)} vs axes "
                         f"{tuple(axes)}")
    used: set = set()
    entries = []
    axis_sizes = mesh_axis_sizes(mesh)
    for dim, name in zip(shape, axes):
        cands = rules.get(name, rules.get(None, [()]))
        chosen: Tuple[str, ...] = ()
        for cand in cands:
            cand = tuple(a for a in cand if a in axis_sizes)
            if not cand:
                chosen = ()
                break
            prod = math.prod(axis_sizes[a] for a in cand)
            if any(a in used for a in cand):
                continue
            if dim % prod != 0:
                continue
            chosen = cand
            break
        used.update(chosen)
        entries.append(chosen if len(chosen) != 1 else chosen[0])
    # trim trailing replicated entries for tidiness
    while entries and entries[-1] == ():
        entries.pop()
    return tuple(e if e != () else None for e in entries)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on its mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    def placements(self) -> list:
        """DTensor placements, one per mesh dim in the mesh's order:
        ``Shard(d)`` where tensor dim d takes that mesh axis, else
        ``Replicate()``. A dim over several mesh axes shards over each; the
        mesh order is then its major-to-minor order, which is JAX's layout
        only when the spec lists the axes in the mesh's order (the rule
        tables do: ``("pod", "data")`` on a mesh ``("pod", "data", ...)``),
        so another order raises."""
        from torch.distributed.tensor import Replicate, Shard
        order = list(mesh_axis_sizes(self.mesh))
        owner: Dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            names = _names(entry)
            pos = [order.index(a) for a in names]
            if pos != sorted(pos):
                raise NotImplementedError(
                    f"spec {self.spec}: dim {d} lists mesh axes {names} out "
                    f"of the mesh's order {tuple(order)}; DTensor shards in "
                    f"mesh order")
            for a in names:
                owner[a] = d
        return [Shard(owner[a]) if a in owner else Replicate()
                for a in order]

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a tensor of global ``shape``."""
        sizes = mesh_axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            out[d] //= math.prod(sizes[a] for a in _names(entry))
        return tuple(out)

    def block(self, shape: Sequence[int],
              coords: Dict[str, int]) -> Tuple[slice, ...]:
        """The index of the block of a tensor of global ``shape`` that the
        device at ``coords`` ({mesh axis: index}; an axis left out is at
        0) holds: a dim over several mesh axes is cut first by the first,
        as JAX lays out a ``PartitionSpec`` entry ``("pod", "data")``."""
        sizes = mesh_axis_sizes(self.mesh)
        out = [slice(None)] * len(shape)
        for d, entry in enumerate(self.spec):
            idx, n = 0, 1
            for a in _names(entry):
                idx, n = idx * sizes[a] + coords.get(a, 0), n * sizes[a]
            if n > 1:
                b = shape[d] // n
                out[d] = slice(idx * b, (idx + 1) * b)
        return tuple(out)

    @property
    def is_replicated(self) -> bool:
        """Every device holds the whole tensor: the spec names no mesh
        axis of more than one device (on a mesh of one, every spec)."""
        sizes = mesh_axis_sizes(self.mesh)
        return all(sizes[a] == 1 for e in self.spec for a in _names(e))


def logical_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                     mesh, rules: Rules) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(shape, axes, mesh, rules))


# ---------------------------------------------------------------------------
# Thread-local rule context so model code can annotate without plumbing.
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[Rules] = None
    data: Any = None
    rows: Any = None


_CTX = _Ctx()


class axis_rules:
    """Context manager enabling ``constrain`` inside model code. ``data``
    is the step's view of its params over the data axis
    (``sharding.fsdp.DataBlocks``), or None where they are whole; ``rows``
    the train step's rows of the batch over ranks
    (``sharding.fsdp.RowBlocks``), or None where a rank holds them all."""

    def __init__(self, mesh, rules: Optional[Rules] = None, data=None,
                 rows=None):
        self.mesh = mesh
        self.rules = rules if rules is not None else ACT_RULES
        self.data = data
        self.rows = rows

    def __enter__(self):
        self._prev = (_CTX.mesh, _CTX.rules, _CTX.data, _CTX.rows)
        _CTX.mesh, _CTX.rules, _CTX.data, _CTX.rows = \
            self.mesh, self.rules, self.data, self.rows
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules, _CTX.data, _CTX.rows = self._prev
        return False


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[Rules]:
    """The active context's activation rules (None outside one)."""
    return _CTX.rules


def current_data():
    """The active context's ``data`` (``sharding.fsdp.current``)."""
    return _CTX.data


def current_rows():
    """The active context's ``rows`` (``sharding.fsdp.current_rows``)."""
    return _CTX.rows


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant)
    that runs the recompute under the rule context active now, at the
    forward: the recompute runs in the backward, which may run on another
    thread (on a card, autograd's device thread), where this thread's
    context is not set."""
    mesh, rules, data, rows = _CTX.mesh, _CTX.rules, _CTX.data, _CTX.rows
    return lambda: (contextlib.nullcontext(),
                    axis_rules(mesh, rules, data, rows))


def constrain(x, axes: Sequence[Optional[str]]):
    """The reference's ``with_sharding_constraint`` under the active rule
    context: the identity outside one or on a mesh of one device, so the
    same model code runs on one card. A DTensor is redistributed to the
    resolved placements; a plain tensor carries no placement (a count on
    meta tensors over a logical mesh) and passes through."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or mesh_size(mesh) == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sh = logical_sharding(x.shape, axes, mesh, rules)
    return x.redistribute(mesh, sh.placements())
