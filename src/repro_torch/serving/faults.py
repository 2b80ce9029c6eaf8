"""Chaos fault plane of the port (port of ``repro/serving/faults.py``).

``FaultPlane`` is a seeded source of injected faults at every trust and
failure boundary the serving stack crosses:

* **device death mid-decode** -- a stage-hosting trust domain is marked
  unhealthy between the telemetry tick's heartbeat pass and the
  replanner's observation, where a real heartbeat loss would surface;
* **stage stall** -- a straggler factor through ``StageTelemetry.inject``,
  so the deviation detector re-plans;
* **sealed-payload corruption and truncation** -- one bit flipped, or one
  trailing row cut, in a swap or transfer manifest's host payload; the
  integrity digest (``enclave.sealing.payload_digest``) turns either into
  a ``SealIntegrityError`` and a recompute fallback;
* **handoff drop and delay** -- a delivery attempt from the prefill role
  to the decode role is lost or parked for a few ticks, driving the
  orchestrator's retry ladder;
* **pool-exhaustion storms** -- a fraction of the free page list is
  seized for a few steps, forcing the preemption and swap machinery.

Every decision is drawn from one ``random.Random(seed)`` stream, consumed
in engine-event order, exactly as the reference's: the same Mersenne
Twister in the same order gives the port the reference's fault schedule
draw for draw, so the two engines can be held against each other under
chaos. Payloads are host numpy arrays in the reference's dtypes
(``sealing.cipher_to_host``), so a tamper picks the same byte and bit. All
of it is host work: recovery rides the swap, transfer and prefill paths
that warmup captured, and nothing here touches the device.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FaultConfig:
    """Per-site injection probabilities (0.0 disables a site), as the
    reference's. ``EngineConfig.faults`` carries one of these or None;
    ``serve --chaos`` builds the ``chaos()`` mix."""

    seed: int = 0
    # device death: per-telemetry-tick probability of killing one healthy
    # stage-hosting domain, at most max_device_deaths times (a survivor
    # always remains)
    device_death: float = 0.0
    max_device_deaths: int = 1
    # stage stall: per-telemetry-tick probability of multiplying one
    # stage's measured time by stall_factor until a re-plan absorbs it
    stage_stall: float = 0.0
    stall_factor: float = 8.0
    # sealed-payload tampering, drawn once per swap-in / handoff delivery:
    # corrupt flips one payload bit, truncate drops a trailing payload row
    corrupt_swap: float = 0.0
    truncate_swap: float = 0.0
    corrupt_transfer: float = 0.0
    truncate_transfer: float = 0.0
    # handoff transit: per-delivery-attempt probabilities
    drop_handoff: float = 0.0
    delay_handoff: float = 0.0
    delay_steps: int = 3
    # pool-exhaustion storm: per-step probability of seizing storm_fraction
    # of the free list for storm_steps engine steps
    pool_storm: float = 0.0
    storm_fraction: float = 0.6
    storm_steps: int = 4

    @classmethod
    def chaos(cls, seed: int = 0, **overrides) -> "FaultConfig":
        """The mix ``serve --chaos`` runs: every site but device death
        armed at rates that fire several times over a short stream."""
        base = dict(
            seed=seed,
            stage_stall=0.10,
            corrupt_swap=0.20, truncate_swap=0.10,
            corrupt_transfer=0.20, truncate_transfer=0.10,
            drop_handoff=0.15, delay_handoff=0.15,
            pool_storm=0.05,
        )
        base.update(overrides)
        return cls(**base)


class FaultPlane:
    """Seeded decisions for one engine's injected faults. Each
    ``maybe_*`` / ``pick_*`` site draws from the one stream and counts in
    ``injected`` when it fires, so every injected fault can be held to a
    recovery rung of the engine (``stats()["recovery"]``)."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self.rng = random.Random(config.seed)
        self.injected: Dict[str, int] = {
            "device_death": 0,
            "stage_stall": 0,
            "corrupt_swap": 0,
            "truncate_swap": 0,
            "corrupt_transfer": 0,
            "truncate_transfer": 0,
            "drop_handoff": 0,
            "delay_handoff": 0,
            "pool_storm": 0,
        }
        self.device_deaths = 0

    def reset(self) -> None:
        """Re-seed the stream and zero the ledger (the warmup reset: a
        warmed engine replays a cold one's fault schedule)."""
        self.rng = random.Random(self.config.seed)
        for k in self.injected:
            self.injected[k] = 0
        self.device_deaths = 0

    def _fire(self, p: float) -> bool:
        return p > 0.0 and self.rng.random() < p

    def total_injected(self) -> int:
        return sum(self.injected.values())

    def snapshot(self) -> Dict[str, int]:
        return dict(self.injected)

    # -- site: device death (telemetry tick) ----------------------------
    def pick_device_death(self, candidates: Sequence[str]) -> Optional[str]:
        """One healthy stage-hosting domain to kill, or None.
        ``candidates`` already excludes domains whose loss would leave no
        survivor: recovery is made expensive, never impossible."""
        if not candidates \
                or self.device_deaths >= self.config.max_device_deaths \
                or not self._fire(self.config.device_death):
            return None
        self.device_deaths += 1
        self.injected["device_death"] += 1
        return sorted(candidates)[self.rng.randrange(len(candidates))]

    # -- site: stage stall (telemetry tick) -----------------------------
    def pick_stage_stall(self, num_stages: int
                         ) -> Optional[Tuple[int, float]]:
        if num_stages < 2 or not self._fire(self.config.stage_stall):
            return None
        self.injected["stage_stall"] += 1
        return (self.rng.randrange(num_stages), self.config.stall_factor)

    # -- site: sealed-payload tampering ---------------------------------
    def _tamper(self, payload: Any, corrupt_p: float, truncate_p: float,
                kind: str, window=None) -> Tuple[Any, Optional[str]]:
        """``(payload', mode)``: mode None (untouched), "corrupt" (one bit
        flipped) or "truncate" (one trailing row cut). Works on copies:
        the manifest's holder swaps the tampered payload in, as a
        man-in-the-middle would, and the original buffers are untouched.
        ``window`` ``(col0, row_cols)``: each part of ``payload`` is
        columns [col0, col0 + cols) of rows ``row_cols`` wide (a pipeline
        rank's share of the payload). The byte is drawn over the whole
        rows, so every rank draws as one device would, and flipped on the
        rank whose columns hold it."""
        mode = None
        if self._fire(corrupt_p):
            mode = "corrupt"
        elif self._fire(truncate_p):
            mode = "truncate"
        if mode is None:
            return payload, None
        parts = [np.asarray(p) for p in payload]
        if mode == "corrupt":
            which = self.rng.randrange(len(parts))
            arr = np.array(parts[which], copy=True)
            col0, row_cols = window or (0, arr.shape[-1])
            size = arr.itemsize
            byte = self.rng.randrange(arr.shape[0] * row_cols * size)
            bit = np.uint8(1 << self.rng.randrange(8))
            row, col = divmod(byte, row_cols * size)
            col -= col0 * size
            # a rank's part may be empty (a data rank other than 0)
            mine = arr.reshape(arr.shape[0], -1).view(np.uint8) \
                if arr.size else None
            if mine is not None and 0 <= col < mine.shape[1]:
                mine[row, col] ^= bit
            parts[which] = arr
        else:
            rows = max(1, parts[0].shape[0] - 1)
            parts = [np.array(p[:rows], copy=True) for p in parts]
        self.injected[f"{mode}_{kind}"] += 1
        return tuple(parts), mode

    def maybe_tamper_swap(self, payload: Any, window=None
                          ) -> Tuple[Any, Optional[str]]:
        return self._tamper(payload, self.config.corrupt_swap,
                            self.config.truncate_swap, "swap", window)

    def maybe_tamper_transfer(self, payload: Any, window=None
                              ) -> Tuple[Any, Optional[str]]:
        return self._tamper(payload, self.config.corrupt_transfer,
                            self.config.truncate_transfer, "transfer", window)

    # -- site: handoff transit ------------------------------------------
    def handoff_fate(self) -> Tuple[str, int]:
        """Fate of ONE delivery attempt: ("deliver", 0); ("drop", 0), the
        attempt is lost and the sender retries; or ("delay", steps), the
        manifest arrives ``steps`` ticks late. Drawn per attempt, so a
        retry can fail again."""
        if self._fire(self.config.drop_handoff):
            self.injected["drop_handoff"] += 1
            return ("drop", 0)
        if self._fire(self.config.delay_handoff):
            self.injected["delay_handoff"] += 1
            return ("delay", 1 + self.rng.randrange(
                max(1, self.config.delay_steps)))
        return ("deliver", 0)

    # -- site: pool-exhaustion storm (per engine step) -------------------
    def storm_pages(self, free_pages: int) -> int:
        """Pages to seize this step (0 = no storm). Never the whole free
        list: a minimal request must stay admissible once the active slots
        are preempted."""
        if free_pages < 4 or not self._fire(self.config.pool_storm):
            return 0
        n = int(free_pages * self.config.storm_fraction)
        n = min(n, free_pages - 2)
        if n <= 0:
            return 0
        self.injected["pool_storm"] += 1
        return n
