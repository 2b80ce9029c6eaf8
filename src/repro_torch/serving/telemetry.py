"""Serving layer 2 — per-stage telemetry feeding the online replanner.

The paper's Sec. V re-partitions "when profiling information deviates from
predictions". Here the serving engine measures each pipeline stage's wall
time (a single-stage probe — ``PipelinedDecoder.build_stage_probe`` —
timed host-side), folds an EMA of the measurements into
``OnlineReplanner.observe()`` every ``interval`` steps, and heartbeats the
``ResourceManager`` for every stage that answered its probe.

Scale normalization: analytic predictions are in modeled device-seconds
while measurements are host wall time, so raw ratios are meaningless.
Observations are rescaled by anchoring the fastest-relative stage at its
prediction (``scale = max_i pred_i/obs_i``, so that stage reads exactly at
spec and every other stage at or above it) — a *uniformly* slow host never
triggers a re-plan (re-placing stages cannot fix global slowness), while a
relative straggler stands out by its slowdown no matter how large its
predicted share.

``inject(stage, factor)`` multiplies a stage's measured time before
normalization — the straggler-injection hook used by tests, the serve CLI
and the throughput benchmark to exercise the live re-plan path on
homogeneous hardware.

A copy of ``repro/serving/telemetry.py`` (host code), with its imports
pointed at ``repro_torch``. In the port the stage probe is
``PipelinedDecoder.build_stage_probe``; on the card the engine times it
with CUDA events (``PagedPipelinedBackend.stage_times``), on the CPU with
the host clock.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Sequence

from repro_torch.core.planner import PlacementSpec
from repro_torch.runtime.ft import HeartbeatMonitor, OnlineReplanner


@dataclasses.dataclass
class StageTelemetry:
    replanner: OnlineReplanner
    monitor: Optional[HeartbeatMonitor] = None
    interval: int = 8                   # observe() every N engine steps
    ema: float = 0.5                    # new-sample weight
    _stage_ema: Dict[int, float] = dataclasses.field(default_factory=dict)
    _inject: Dict[int, float] = dataclasses.field(default_factory=dict)
    # recent window only (ring buffer) — wall_s/steps_recorded keep lifetime
    # totals exact so a week-long serve doesn't grow host memory per step
    step_times_cap: Optional[int] = None
    step_times: Deque[float] = dataclasses.field(default_factory=deque)
    wall_s: float = 0.0
    steps_recorded: int = 0
    observations: int = 0

    def __post_init__(self):
        self.step_times = deque(self.step_times, maxlen=self.step_times_cap)

    # -- fault injection ----------------------------------------------------
    def inject(self, stage: int, factor: float) -> None:
        """Multiply stage ``stage``'s measured time by ``factor`` (straggler
        injection; factor 1.0 clears)."""
        if factor == 1.0:
            self._inject.pop(stage, None)
        else:
            self._inject[stage] = factor

    # -- measurement --------------------------------------------------------
    def record_step(self, wall_dt: float) -> None:
        self.step_times.append(wall_dt)
        self.wall_s += wall_dt
        self.steps_recorded += 1

    def reset_measurements(self) -> None:
        """Zero the wall-time accounting (warmup reset / benchmark phase
        boundaries) without touching replanner state or stage EMAs."""
        self.step_times.clear()
        self.wall_s = 0.0
        self.steps_recorded = 0

    def record_stage_times(self, times: Sequence[float]) -> None:
        """Fold one per-stage probe (host wall seconds, stage order) into the
        EMA. Heartbeats every device hosting a stage that answered."""
        current = self.replanner.current
        for i, t in enumerate(times):
            t = t * self._inject.get(i, 1.0)
            prev = self._stage_ema.get(i)
            self._stage_ema[i] = t if prev is None else \
                (1 - self.ema) * prev + self.ema * t
            if current is not None and i < len(current.placement.stages):
                self.replanner.rm.heartbeat(current.placement.stages[i].device)

    def predicted_shares(self) -> List[float]:
        """Per-stage predicted time fractions (LocalDecodeBackend fallback:
        attribute a whole-step measurement proportionally, so only *injected*
        deviation registers)."""
        cur = self.replanner.current
        if cur is None:
            return []
        total = sum(cur.stage_times) or 1.0
        return [t / total for t in cur.stage_times]

    # -- the observe tick ---------------------------------------------------
    def scaled_observations(self) -> Dict[tuple, float]:
        """EMA measurements keyed (device, stage_idx), rescaled into the
        prediction's units by anchoring on the *fastest-relative* stage:
        ``scale = max_i pred_i / obs_i``, so the best-behaved stage reads
        exactly at spec and a straggler stands out by its relative slowdown —
        even when it dominates the predicted total (a total-sum rescale
        would absorb it)."""
        cur = self.replanner.current
        if cur is None or not self._stage_ema:
            return {}
        stages = cur.placement.stages
        obs = {i: t for i, t in self._stage_ema.items()
               if i < len(stages) and t > 0.0}
        if not obs:
            return {}
        scale = max(cur.stage_times[i] / t for i, t in obs.items())
        if scale <= 0.0:
            return {}
        return {(stages[i].device, i): t * scale for i, t in obs.items()}

    def maybe_observe(self, step: int) -> Optional[PlacementSpec]:
        """Every ``interval`` steps: sweep heartbeats and feed the scaled
        observations to the replanner. Returns the new PlacementSpec when
        the replanner decided to re-plan (the engine then swaps boundaries)."""
        if step == 0 or step % self.interval:
            return None
        if self.monitor is not None:
            self.monitor.sweep()
        scaled = self.scaled_observations()
        self.observations += 1
        new_spec = self.replanner.observe(scaled)
        if new_spec is not None:
            # measurements were relative to the old placement
            self._stage_ema.clear()
        return new_spec
