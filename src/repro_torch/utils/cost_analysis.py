"""Roofline terms from a counted step (the port's counterpart of
``repro/utils/hlo_analysis.py``, which reads a compiled XLA artifact).

The port compiles nothing, so the counts come from running the step
under two dispatch modes: FLOPs from ``torch.utils.flop_counter``'s
``FlopCounterMode`` (matmuls, convolutions and attention; the plain
attention is two einsums over the full [Sq, Sk] scores, masked, so a
causal prefill counts the whole square) and bytes from ``ByteCounter``,
which adds up every aten op's tensor operands and results. That is the
traffic of the unfused program, op by op; XLA's ``bytes accessed``
counts after fusion, so the two do not compare, and neither is a
measurement.

Count on meta tensors. The hand-written kernels are launched through
ctypes (``kernels/ops.py``), so on the card a dispatch mode sees nothing
of them; on meta (as on the CPU) every wrapper takes its plain version
and attention's products are visible. The dry-run and the calibration
count on meta always, and so need no memory for the tensors they count.

The reference's ``walk_collectives`` reads the partitioned HLO. Its
counterpart needs the model running as DTensors over a mesh of several
ranks (ROADMAP item 10); until then the dry-run writes no collective
bytes, and its roofline's ``coll_bytes`` is 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# H100 SXM5 datasheet figures (NVIDIA H100 Tensor Core GPU datasheet), per
# card: dense bf16 tensor-core peak, HBM3 bandwidth, NVLink 4 per
# direction (900 GB/s both ways). Datasheet figures, not measurements.
PEAK_FLOPS = 989e12          # bf16, dense
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s, NVLink, one direction


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results. View
    ops (a reshape, a transpose, a slice) move nothing and are skipped, and
    so is a copy between devices (a host array onto the device is a
    transfer, not a device op's traffic; made once and cached, it would
    otherwise make a count depend on what ran before it)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ts = [t for t in tree_leaves((args, kwargs, out))
                  if isinstance(t, torch.Tensor)]
            if len({t.device for t in ts}) <= 1:
                self.bytes += sum(t.numel() * t.element_size() for t in ts)
        return out


# the counters of the cost_summary calls in progress
_ACTIVE: List[Tuple[FlopCounterMode, ByteCounter]] = []


@contextlib.contextmanager
def repeat(n: int):
    """Counts what runs inside ``n`` times over in every active
    ``cost_summary``: a loop whose steps all have one step's shapes runs
    one step on meta tensors and counts it by the trip count (what
    ``walk_collectives`` does for an XLA while loop). Outside a count it
    does nothing."""
    before = [(_flop_table(f), c.bytes) for f, c in _ACTIVE]
    yield
    for (f, c), (table, b0) in zip(_ACTIVE, before):
        for mod, ops in f.flop_counts.items():
            for op, v in list(ops.items()):
                ops[op] += (n - 1) * (v - table.get((mod, op), 0))
        c.bytes += (n - 1) * (c.bytes - b0)


def _flop_table(f: FlopCounterMode) -> Dict[tuple, int]:
    return {(mod, op): v for mod, ops in f.flop_counts.items()
            for op, v in ops.items()}


def cost_summary(fn, *args, **kwargs) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one call ``fn(*args, **kwargs)``, run
    under ``FlopCounterMode`` and ``ByteCounter`` (the reference's
    ``cost_summary`` reads the same two numbers from ``cost_analysis()``).
    Run it on meta tensors (see the module's docstring)."""
    flops = FlopCounterMode(display=False)
    counter = ByteCounter()
    _ACTIVE.append((flops, counter))
    try:
        with flops, counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes)}


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * self.ici_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
        }
