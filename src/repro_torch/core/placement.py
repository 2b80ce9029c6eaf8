"""Backward-compatible shim over :mod:`repro_torch.core.planner` (the
port's copy of ``repro/core/placement.py``).

The placement machinery (paper Sec. IV–V: placement-tree enumeration with the
pipelined chunk-completion cost model) lives in the layered planner
package — ``planner.profiling`` (profiles + O(1) cost tables),
``planner.solvers`` (exhaustive/DP/beam behind the ``Solver`` protocol) and
``planner.evaluation`` (Eq. 1–2 cost + result types). This module keeps the
original import surface and the original ``solve()`` signature; new code
should call ``planner.solve(..., solver="dp")`` and use the richer
``SolveResult`` it returns.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .cost_model import DeviceProfile
from .planner import (Evaluation, LayerProfile, Placement,  # noqa: F401
                      PlacementSpec, ResourceGraph, Segment, Stage,
                      enumerate_placements, enumerate_segment_placements,
                      evaluate, profiles_from_arch, profiles_from_cnn,
                      spec_from_boundaries, stage_exec_direct)
from .planner import solve as _planner_solve


def _stage_exec(profiles: Sequence[LayerProfile], stage: Stage,
                device: DeviceProfile) -> float:
    """Legacy helper (benchmarks use it for per-stage breakdowns)."""
    return stage_exec_direct(profiles, stage.start, stage.end, device)


def solve(profiles: Sequence[LayerProfile], graph: ResourceGraph, *,
          n: int, delta: float, max_trusted: Optional[int] = None,
          pipelined: bool = True) -> Tuple[Evaluation, List[Evaluation]]:
    """Legacy entry point: exhaustive enumerate/evaluate/argmin.

    pipelined=False reproduces the 'No pipelining' baseline (optimizes n=1
    latency, then pays n * t_frame on a stream).
    """
    res = _planner_solve(profiles, graph, n=n, delta=delta,
                         max_trusted=max_trusted, pipelined=pipelined,
                         solver="exhaustive")
    return res.as_tuple()
