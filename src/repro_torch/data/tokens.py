"""Synthetic LM data pipeline with checkpointable iterator state (the
port's copy of ``repro/data/tokens.py``: numpy only, so the port keeps its
own and the same seed and step give the same arrays in both packages).

Deterministic: batch at step s is a pure function of (seed, s), so resuming
from a checkpointed step reproduces the exact data order — the property the
fault-tolerance tests assert. A Zipf-ish marginal over the vocab plus a
shift-structure (labels = tokens rolled by 1 with noise) gives the model
something learnable for the end-to-end "loss goes down" example.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticTokenStream:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    step: int = 0                      # checkpointable cursor
    structure: float = 0.9             # P(next token follows the pattern)

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # Zipf-ish marginal, then a deterministic successor pattern
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64) % V
        succ = (base * 31 + 7) % V
        follow = rng.random((B, S)) < self.structure
        tokens = base.astype(np.int32)
        labels = np.where(follow, succ, rng.integers(0, V, (B, S))).astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


@dataclasses.dataclass
class HostShardedStream:
    """Wraps a stream, yielding this host's shard — the multi-host data
    loading pattern (each host feeds its addressable devices)."""

    base: SyntheticTokenStream
    host_index: int = 0
    host_count: int = 1

    def __next__(self):
        b = next(self.base)
        B = b["tokens"].shape[0]
        per = B // self.host_count
        lo = self.host_index * per
        return {k: v[lo:lo + per] for k, v in b.items()}

    def __iter__(self):
        return self

    def state_dict(self):
        return self.base.state_dict()

    def load_state_dict(self, s):
        self.base.load_state_dict(s)
