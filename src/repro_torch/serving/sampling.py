"""Token sampling of the port: greedy only (port of the temperature-0 path
of ``repro/serving/sampling.py``).

``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so the
port's greedy streams equal the reference's. Sampled decoding needs the
reference's per-(rid, index) ``jax.random`` keys, i.e. a threefry-2x32
port, which is a later slice (ROADMAP.md, "Next slices", item 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenSampler:
    temperature: float = 0.0

    def __post_init__(self):
        if self.temperature > 0.0:
            raise NotImplementedError(
                "temperature > 0 needs the reference's threefry keystream "
                "(jax.random.categorical per (rid, index)); the port serves "
                "greedy only until the sampling slice (ROADMAP.md, 'Next "
                "slices', item 3)")

    def sample(self, logits: torch.Tensor, rids: np.ndarray,
               indices: np.ndarray) -> np.ndarray:
        """logits [B, V] -> greedy tokens [B] (int32, on the host)."""
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    def sample_one(self, logits: torch.Tensor, rid: int, index: int) -> int:
        return int(self.sample(logits[:1], np.asarray([rid]),
                               np.asarray([index]))[0])
