"""Fault-tolerant training loop (the port of ``repro/runtime/train_loop.py``).

* checkpoint/restart — atomic async checkpoints every N steps, exact resume
  (params, optimizer, data-iterator cursor, RNG-free determinism);
* preemption handling — SIGTERM/flag triggers a final blocking save;
* straggler detection — per-step wall-time EMA; a step slower than
  ``straggler_factor``x the EMA fires the on_straggler hook;
* restore onto the devices and dtypes of the loop's own state
  (``CheckpointManager.restore``).

The loop reads the loss back each step (``float(loss)``), the one host
sync of a step; the step's time therefore covers its device work.

Over ranks (``launch.ranks``) every rank runs the loop on its own state;
rank 0 alone writes checkpoints, and every rank restores from them. The
compressed step's error-feedback buffer rides in ``extra_step_args``
(passed ahead of the batch, replaced by what the step returns) and, as in
the reference, is not checkpointed: a resumed compressed run restarts it
from zeros.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_decay: float = 0.9


class TrainLoop:
    def __init__(self, *, train_step, params, opt_state, data,
                 ckpt: Optional[CheckpointManager] = None,
                 cfg: TrainLoopConfig = TrainLoopConfig(),
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None,
                 extra_step_args: tuple = ()):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.extra_step_args = extra_step_args
        self.step = 0
        self.losses: list = []
        self.gnorms: list = []
        self.step_times: list = []
        self.straggler_events: list = []
        self._preempted = False
        self._ema: Optional[float] = None
        self._measured = 0                 # steps timed (the first warms up)

    # -- preemption -----------------------------------------------------
    def install_signal_handler(self):
        """SIGTERM sets the preemption flag; returns the handler it
        replaced, for the caller to put back."""
        def handler(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, handler)

    def preempt(self):
        """Programmatic preemption (tests / orchestrator)."""
        self._preempted = True

    # -- checkpoint -----------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, block: bool = False):
        if self.ckpt is None or (dist.is_initialized()
                                 and dist.get_rank() != 0):
            return
        extra = {"data": self.data.state_dict()
                 if hasattr(self.data, "state_dict") else {},
                 "step": self.step}
        self.ckpt.save(self.step, self._state_tree(), extra=extra,
                       block=block)

    def try_restore(self) -> bool:
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        restored = self.ckpt.restore(latest, self._state_tree())
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        extra = self.ckpt.manifest(latest)["extra"]
        if hasattr(self.data, "load_state_dict") and extra.get("data"):
            self.data.load_state_dict(extra["data"])
        self.step = int(extra.get("step", latest))
        return True

    # -- main loop --------------------------------------------------------
    def run(self, num_steps: Optional[int] = None) -> Dict:
        n = num_steps if num_steps is not None else self.cfg.total_steps
        end = self.step + n
        while self.step < end and not self._preempted:
            t0 = time.monotonic()      # include the input pipeline: a slow
            batch = next(self.data)    # host data feed is also a straggler
            out = self.train_step(self.params, self.opt_state,
                                  *self.extra_step_args, batch,
                                  np.int32(self.step))
            if len(out) == 4:
                loss, self.params, self.opt_state, gnorm = out
            else:              # the compressed step returns its ef too
                loss, self.params, self.opt_state, ef, gnorm = out
                self.extra_step_args = (ef,)
            loss = float(loss)
            dt = time.monotonic() - t0
            # straggler detection on steady-state steps; the first measured
            # step warms up (kernel builds, allocator) and never seeds the
            # EMA
            self._measured += 1
            if self._measured >= 2:
                if self._ema is None:
                    self._ema = dt
                elif dt > self.cfg.straggler_factor * self._ema:
                    self.straggler_events.append((self.step, dt, self._ema))
                    if self.on_straggler:
                        self.on_straggler(self.step, dt, self._ema)
                    # do not fold the outlier into the EMA
                else:
                    self._ema = (self.cfg.ema_decay * self._ema
                                 + (1 - self.cfg.ema_decay) * dt)
            self.losses.append(loss)
            self.gnorms.append(float(gnorm))
            self.step_times.append(dt)
            self.step += 1
            if self.ckpt and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self._preempted:
            self.save(block=True)     # final blocking save on preemption
        if self.ckpt:
            self.ckpt.wait()
        return {"losses": self.losses, "step": self.step,
                "stragglers": self.straggler_events,
                "preempted": self._preempted, "gnorms": self.gnorms,
                "step_times": self.step_times}
