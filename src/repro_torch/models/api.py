"""Model API of the port (dense and MoE families of ``repro/models/api.py``):
``build_model(cfg, device=..., dtype=..., max_seq=..., cache_quant=...)``
returns a ``ModelAPI`` whose closures the serving engine and the train
step call."""
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
    max_seq: int = 4096                 # the timeline cache's default horizon

    def param_specs(self):
        return self.model.param_specs()

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (which must live on
        ``self.device``), in ``self.dtype``."""
        return self.model.init_params(generator, self.device, self.dtype)

    def loss_fn(self, params, batch):
        """Mean next-token nll of a training batch (see StackedLM.loss_fn)."""
        return self.model.loss_fn(params, batch)

    # -- timeline KV cache (shared position horizon) --------------------------
    def prefill_fn(self, params, batch):
        """Whole-batch prefill into a fresh timeline cache (see
        StackedLM.prefill_fn)."""
        return self.model.prefill_fn(params, batch)

    def decode_fn(self, params, cache, batch):
        """One decode step over the timeline cache, updated in place (see
        StackedLM.decode_fn)."""
        return self.model.decode_fn(params, cache, batch)

    def init_cache_specs(self, batch: int, max_seq: Optional[int] = None):
        return self.model.init_cache_specs(batch, max_seq or self.max_seq,
                                           self.dtype)

    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   fill_len: int = 0) -> Dict[str, Any]:
        """A zero timeline cache (the int8 cache's scales zero too) with
        ``len`` = ``fill_len``, on ``self.device``."""
        specs = self.init_cache_specs(batch, max_seq)
        cache = {SEGMENT: tuple(torch.zeros(shape, dtype=dt,
                                            device=self.device)
                                for shape, dt in specs[SEGMENT])}
        cache["len"] = torch.tensor(fill_len, dtype=torch.int32,
                                    device=self.device)
        return cache

    @property
    def paged_ok(self) -> bool:
        """Paged decode support: false for an int8-cache model, which keeps
        the timeline layout."""
        return self.model.paged_ok

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
                dtype: torch.dtype = torch.bfloat16,
                remat: bool = True, max_seq: int = 4096,
                cache_quant: bool = False) -> ModelAPI:
    """Dense and MoE families (an MoE config with a dense stem,
    ``first_k_dense > 0``, is refused by name, as the reference's engine
    refuses to serve it). ``device`` defaults to ``cuda`` and raises
    without a card; pass ``device="cpu"`` for the CPU reference path.
    ``remat`` recomputes each block in the backward of ``loss_fn`` (the
    reference's default). ``max_seq`` is the timeline cache's default
    horizon; ``cache_quant`` keeps the timeline cache in int8 (no paged
    cache then, as in the reference)."""
    dev = resolve_device(device)
    return ModelAPI(cfg, StackedLM(cfg, remat=remat, cache_quant=cache_quant),
                    dev, dtype, max_seq)
