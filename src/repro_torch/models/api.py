"""Model API of the port (dense and MoE families of ``repro/models/api.py``):
``build_model(cfg, device=..., dtype=...)`` returns a ``ModelAPI`` whose
closures the serving engine calls."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from .transformer import SEGMENT, StackedLM


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    model: StackedLM
    device: torch.device
    dtype: torch.dtype

    def param_specs(self):
        return self.model.param_specs()

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (which must live on
        ``self.device``), in ``self.dtype``."""
        return self.model.init_params(generator, self.device, self.dtype)

    # -- paged per-slot KV cache (serving hot path) ---------------------------
    def init_paged_cache_specs(self, num_slots: int, num_pages: int,
                               page_size: int, pages_per_slot: int):
        return self.model.init_paged_cache_specs(
            num_slots, num_pages, page_size, pages_per_slot, self.dtype)

    def init_paged_cache(self, num_slots: int, num_pages: int,
                         page_size: int, pages_per_slot: int):
        specs = self.init_paged_cache_specs(num_slots, num_pages, page_size,
                                            pages_per_slot)

        def zeros(spec):
            shape, dtype = spec
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {k: (tuple(zeros(s) for s in v) if k == SEGMENT else zeros(v))
                for k, v in specs.items()}

    def decode_paged_fn(self, params, cache, batch):
        return self.model.decode_paged_fn(params, cache, batch)

    def prefill_at_fn(self, params, batch):
        """Right-padded whole-prompt prefill (see StackedLM.prefill_at_fn)."""
        return self.model.prefill_at_fn(params, batch)

    def prefill_packed_fn(self, params, batch):
        """K right-padded prompts in one call, logits per row at its own
        last position (see StackedLM.prefill_packed_fn)."""
        return self.model.prefill_packed_fn(params, batch)

    def prefill_chunk_fn(self, params, pools, batch):
        """One prefill chunk against the live page pools, which it updates
        in place (see StackedLM.prefill_chunk_fn)."""
        return self.model.prefill_chunk_fn(params, pools, batch)


def build_model(cfg: ArchConfig, *,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16) -> ModelAPI:
    """Dense and MoE families (an MoE config with a dense stem,
    ``first_k_dense > 0``, is refused by name, as the reference's engine
    refuses to serve it). ``device`` defaults to ``cuda`` and raises
    without a card; pass ``device="cpu"`` for the CPU reference path."""
    dev = resolve_device(device)
    return ModelAPI(cfg, StackedLM(cfg), dev, dtype)
