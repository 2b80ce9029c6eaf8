"""Discrete-event pipeline simulator — replays Fig. 6's schedule exactly.

Stages (devices) and links are FIFO servers; all n frames are available at
t=0 (the paper's chunk model). Used to validate the closed-form Eq. 1–2 cost
in `placement.evaluate` (property-tested: they agree for any stage/link
times) and to produce the Fig. 12/13 timelines.

A copy of ``repro/core/pipeline_sim.py`` (host code).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class SimResult:
    completion_time: float
    per_frame_departure: List[float]
    busy_time: List[float]         # per server (stage0, link0, stage1, ...)

    def utilization(self) -> List[float]:
        return [b / self.completion_time for b in self.busy_time]


def simulate_pipeline(stage_times: Sequence[float],
                      link_times: Sequence[float],
                      n_frames: int) -> SimResult:
    """Alternating servers: stage_0, link_0, stage_1, ..., stage_{k-1}.

    Each server processes frames in order; frame f enters server j when both
    (a) it has left server j-1 and (b) server j finished frame f-1.
    """
    assert len(link_times) == len(stage_times) - 1
    servers: List[float] = []
    for i, st in enumerate(stage_times):
        servers.append(st)
        if i < len(link_times):
            servers.append(link_times[i])
    k = len(servers)
    free_at = [0.0] * k
    busy = [0.0] * k
    departures: List[float] = []
    for _f in range(n_frames):
        t = 0.0
        for j, cost in enumerate(servers):
            start = max(t, free_at[j])
            t = start + cost
            free_at[j] = t
            busy[j] += cost
        departures.append(t)
    return SimResult(departures[-1] if departures else 0.0, departures, busy)


def closed_form_completion(stage_times: Sequence[float],
                           link_times: Sequence[float],
                           n_frames: int) -> float:
    """Eq. 1–2: Σ services + (n-1) * bottleneck."""
    servers = list(stage_times) + list(link_times)
    return sum(servers) + (n_frames - 1) * max(servers)
