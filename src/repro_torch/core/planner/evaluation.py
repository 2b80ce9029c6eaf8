"""Planner cost evaluation (Eq. 1–2) and result types.

A placement assigns contiguous layer ranges (stages) to devices, in any
order and with trusted/untrusted stages interleaving freely (the
PlacementSpec segment-graph model): processing must start in a trusted
domain (C1) and every layer of an *untrusted* stage — wherever it sits in
the chain — needs input dissimilar from the original (C2). ``evaluate``
has always been order-agnostic; the prefix restriction lived in the
solvers' search spaces, not here. TEE→TEE boundaries charge seal+unseal;
boundaries into or out of an untrusted device transfer in the clear (the
exposure is exactly what C2 constrains and ``spec.cut_costs`` prices).

Cost model (Eq. 1–2): with per-frame stage times e_s and boundary transfer
times tr_s, a chunk of n frames completes in

    t_chunk(n, P) = Σ_s e_s + Σ_s tr_s + (n-1) * max(max_s e_s, max_s tr_s)

— for n=1 this is single-frame latency (the Neurosurgeon objective, our
"no-pipelining" baseline); for large n it is dominated by the bottleneck
stage, the paper's key observation.

``evaluate`` keeps the exact per-layer semantics of the original
implementation (the correctness oracle); pass ``tables=`` (a
``profiling.CostTables``) to get the same numbers from O(1) queries per
stage — the incremental path every non-exhaustive solver uses.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..cost_model import seal_time, transmit_time
from .profiling import (CostTables, LayerProfile, ResourceGraph,
                        stage_exec_direct)


@dataclasses.dataclass(frozen=True)
class Stage:
    device: str
    start: int                 # inclusive layer index
    end: int                   # exclusive

    @property
    def size(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class Placement:
    stages: Tuple[Stage, ...]

    def device_of(self, layer: int) -> str:
        for s in self.stages:
            if s.start <= layer < s.end:
                return s.device
        raise IndexError(layer)

    def stage_sizes(self) -> Tuple[int, ...]:
        """Per-stage layer counts — feed to PipelinedDecoder(stage_blocks=)."""
        return tuple(s.size for s in self.stages)

    def describe(self) -> str:
        return " | ".join(f"L{s.start}..L{s.end - 1}@{s.device}"
                          for s in self.stages)


@dataclasses.dataclass(frozen=True)
class Evaluation:
    placement: Placement
    stage_times: Tuple[float, ...]
    link_times: Tuple[float, ...]
    bottleneck: float
    t_chunk: float             # for the requested n
    t_frame: float             # n = 1 latency
    max_similarity: float      # privacy leakage over untrusted inputs
    feasible: bool


@dataclasses.dataclass
class SolveResult:
    """Solver output: the argmin plus search-effort accounting.

    ``n_feasible``/``n_pruned`` partition the candidates a solver actually
    considered: exhaustive counts every enumerated placement (pruned =
    privacy/C1-infeasible); DP/beam count finalized states (pruned =
    dominance- or width-eliminated partial states plus infeasible suffixes).
    """
    best: Evaluation
    evaluations: List[Evaluation]
    n_candidates: int
    n_feasible: int
    n_pruned: int
    solver: str
    wall_time_s: float = 0.0
    truncated: bool = False    # beam width fired: optimality not guaranteed

    def as_tuple(self) -> Tuple[Evaluation, List[Evaluation]]:
        """The legacy ``solve()`` return shape."""
        return self.best, self.evaluations


def evaluate(placement: Placement, profiles: Sequence[LayerProfile],
             graph: ResourceGraph, n: int, delta: float,
             input_similarity: float = 1.0,
             tables: Optional[CostTables] = None) -> Evaluation:
    stage_times: List[float] = []
    link_times: List[float] = []
    max_sim = 0.0
    feasible = True

    for idx, stage in enumerate(placement.stages):
        dev = graph.devices[stage.device]
        if tables is not None:
            t = tables.stage_time(stage.device, stage.start, stage.end)
        else:
            t = stage_exec_direct(profiles, stage.start, stage.end, dev)
        # sealing: TEE seals its boundary output; receiving TEE unseals.
        if idx + 1 < len(placement.stages):
            nxt = graph.devices[placement.stages[idx + 1].device]
            if dev.trusted and nxt.trusted:
                t += seal_time(profiles[stage.end - 1].out_bytes, dev)
        if idx > 0:
            prev = graph.devices[placement.stages[idx - 1].device]
            if prev.trusted and dev.trusted:
                t += seal_time(profiles[stage.start - 1].out_bytes, dev)
        stage_times.append(t)
        if idx + 1 < len(placement.stages):
            nxt_stage = placement.stages[idx + 1]
            link_times.append(transmit_time(
                profiles[stage.end - 1].out_bytes,
                graph.link(stage.device, nxt_stage.device)))

        # privacy: every layer on an untrusted device needs dissimilar input
        if not dev.trusted:
            if tables is not None:
                sim = tables.max_sim(stage.start, stage.end)
                max_sim = max(max_sim, sim)
                if sim >= delta:
                    feasible = False
            else:
                for x in range(stage.start, stage.end):
                    sim = (input_similarity if x == 0
                           else profiles[x - 1].similarity)
                    max_sim = max(max_sim, sim)
                    if sim >= delta:
                        feasible = False
        # C1 start rule: the first stage must be trusted
        if idx == 0 and not dev.trusted:
            feasible = False

    bottleneck = max(stage_times + (link_times or [0.0]))
    total = sum(stage_times) + sum(link_times)
    t_chunk = total + (n - 1) * bottleneck
    return Evaluation(placement, tuple(stage_times), tuple(link_times),
                      bottleneck, t_chunk, total, max_sim, feasible)
