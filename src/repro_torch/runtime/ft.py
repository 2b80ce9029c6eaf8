"""Fault tolerance for the serving pipeline: heartbeats, straggler
detection, and Serdab re-planning (the paper's 'online re-partitioning when
profiling information deviates from predictions', Sec. V).

Planning goes through ``ResourceManager.plan()/replan_on_failure()`` (the
planner's re-planning layer, DESIGN.md §Planner), which return a
``PlacementSpec`` — the segment-graph placement the runtime consumes
directly (``PipelinedDecoder.from_spec`` / ``ServingEngine``). Cost tables
are cached on the manager, so a failure-driven re-solve only pays for the
solver pass. Failed devices drop out of the resource graph before the
re-solve, so exclusion holds wherever the device sat in the segment chain —
mid-chain untrusted segments included, not just a trailing suffix.

A copy of ``repro/runtime/ft.py`` (host code, no device work), with its
imports pointed at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.planner import (Evaluation, InfeasibleError,
                                      LayerProfile, PlacementSpec,
                                      SolveResult)
from repro_torch.enclave.domain import ResourceManager

StageKey = Union[int, Tuple[str, int], str]


@dataclasses.dataclass
class HeartbeatMonitor:
    rm: ResourceManager
    timeout_s: float = 10.0

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Marks domains whose heartbeat is stale; returns their names."""
        now = now if now is not None else time.monotonic()
        dead = []
        for d in self.rm.domains():
            if d.healthy and now - d.last_heartbeat > self.timeout_s:
                self.rm.mark_unhealthy(d.name)
                dead.append(d.name)
        return dead


@dataclasses.dataclass
class OnlineReplanner:
    """Watches per-stage observed rates and re-runs the placement solver
    when observation deviates from prediction (or a domain dies).

    ``plan()``/``observe()`` return the new ``PlacementSpec``;
    ``self.current`` keeps the matching ``Evaluation`` (predicted stage
    times drive deviation detection), ``self.current_spec`` the spec."""

    rm: ResourceManager
    profiles: Sequence[LayerProfile]
    n: int
    delta: float
    deviation_threshold: float = 1.5
    derate_floor: float = 0.05          # cumulative derate never drops below
    solver: str = "dp"
    space: str = "segment"              # PlacementSpec search space
    min_stages: Optional[int] = None    # serving: use every pipeline pod
    current: Optional[Evaluation] = None
    current_spec: Optional[PlacementSpec] = None
    last_result: Optional[SolveResult] = None
    replans: int = 0
    # failure-driven re-solves (dead domain excluded) vs deviation-driven
    # ones, and every domain ever excluded — the chaos fault plane's
    # property test attributes each injected device death to exactly one
    # failure_replan whose excluded set names the corpse
    failure_replans: int = 0
    excluded_devices: List[str] = dataclasses.field(default_factory=list)

    def _adopt(self, spec: PlacementSpec) -> PlacementSpec:
        self.last_result = self.rm.last_plan
        self.current = self.rm.last_plan.best
        self.current_spec = spec
        return spec

    def plan(self) -> PlacementSpec:
        spec = self.rm.plan(self.profiles, n=self.n, delta=self.delta,
                            solver=self.solver, space=self.space,
                            min_stages=self.min_stages)
        return self._adopt(spec)

    def _resolve(self, key: StageKey, predicted) -> Optional[Tuple[str, int]]:
        """Normalize an observation key to (device, stage_idx). A bare device
        name (legacy callers) matches that device's slowest predicted stage —
        NOT silently the last one, which dropped observations when a device
        hosted several stages."""
        stages = self.current.placement.stages
        if isinstance(key, tuple):
            return key if key in predicted else None
        if isinstance(key, int):
            return (stages[key].device, key) if 0 <= key < len(stages) else None
        mine = [k for k in predicted if k[0] == key]
        return max(mine, key=lambda k: predicted[k]) if mine else None

    def observe(self, stage_times: Mapping[StageKey, float]
                ) -> Optional[PlacementSpec]:
        """stage_times: measured per-stage wall time, keyed by stage index,
        ``(device, stage_idx)``, or device name (legacy). Re-plans when any
        stage runs deviation_threshold x slower than the plan predicted, or
        when the plan references a dead domain — wherever in the segment
        chain the dead device sat. Deviations derate the hosting device's
        profile through ``ResourceManager.derate`` — cumulative and floored,
        so repeated misses cannot drive ``flops_per_s`` to zero."""
        if self.current is None:
            return self.plan()
        stages = self.current.placement.stages
        predicted = {(s.device, i): t for i, (s, t) in
                     enumerate(zip(stages, self.current.stage_times))}
        healthy = {d.name for d in self.rm.healthy_domains()}
        dead = [s.device for s in stages if s.device not in healthy]
        needs_replan = bool(dead)
        for key, obs in stage_times.items():
            k = self._resolve(key, predicted)
            pred = predicted.get(k) if k is not None else None
            if pred and obs > self.deviation_threshold * pred:
                self.rm.derate(k[0], pred / obs, floor=self.derate_floor)
                needs_replan = True
        if needs_replan:
            self.replans += 1
            if dead:
                self.failure_replans += 1
                self.excluded_devices.extend(
                    d for d in dead if d not in self.excluded_devices)
                try:
                    spec = self.rm.replan_on_failure(
                        dead, profiles=self.profiles, n=self.n,
                        delta=self.delta, solver=self.solver,
                        space=self.space)
                except InfeasibleError:
                    if self.min_stages is None:
                        raise
                    # not enough survivors for the stage floor: best effort
                    spec = self.rm.replan_on_failure(
                        dead, profiles=self.profiles, n=self.n,
                        delta=self.delta, solver=self.solver,
                        space=self.space, min_stages=None)
                return self._adopt(spec)
            return self.plan()
        return None
