"""Video-frame chunk stream — the paper's IoT data model (Sec. IV); the
port's copy of ``repro/data/stream.py`` (numpy only).

Frames arrive as an unbounded stream aggregated into chunks of duration T
(size n). The synthetic source generates structured frames (moving blobs on
a textured background) so the privacy benchmarks have object-like content;
state is checkpointable like the token stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class VideoChunkStream:
    resolution: int = 224
    chunk_size: int = 32               # n frames per chunk
    seed: int = 0
    chunk_index: int = 0

    def state_dict(self):
        return {"chunk_index": self.chunk_index, "seed": self.seed}

    def load_state_dict(self, s):
        self.chunk_index = int(s["chunk_index"])
        self.seed = int(s["seed"])

    def frame(self, chunk: int, i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, chunk, i]))
        R = self.resolution
        yy, xx = np.mgrid[0:R, 0:R].astype(np.float32) / R
        # textured background + a moving bright "object" blob
        bg = 0.35 + 0.12 * np.sin(14 * xx + rng.uniform(0, 6)) * \
            np.cos(11 * yy + rng.uniform(0, 6))
        cx, cy = rng.uniform(0.25, 0.75, 2)
        r = rng.uniform(0.08, 0.18)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
        img = np.clip(bg + 0.6 * blob + 0.02 * rng.standard_normal((R, R)), 0, 1)
        return np.stack([img, img * 0.9, img * 0.8], axis=-1).astype(np.float32)

    def __next__(self) -> List[np.ndarray]:
        c = self.chunk_index
        self.chunk_index += 1
        return [self.frame(c, i) for i in range(self.chunk_size)]

    def __iter__(self) -> Iterator[List[np.ndarray]]:
        return self
