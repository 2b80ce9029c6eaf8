"""Model API of the port (``repro/models/api.py``, every family):
``build_model(cfg, device=..., dtype=..., max_seq=..., cache_quant=...)``
returns a ``ModelAPI`` whose closures the serving engine and the train
step call, with the reference's ``input_specs`` / ``make_inputs`` for a
shape cell. ``ModelAPI.model`` is a ``StackedLM`` (dense, MoE, VLM,
Hymba, xLSTM) or a ``WhisperModel``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ArchConfig, ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.tree import map_tree
from .hymba import build_hymba
from .moe import build_moe
from .transformer import build_dense, build_vlm, map_specs
from .whisper import WhisperModel
from .xlstm import build_xlstm


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    model: Any                          # a StackedLM or a WhisperModel
    device: torch.device
    dtype: torch.dtype
    max_seq: int = 4096                 # the timeline cache's default horizon

    def param_specs(self):
        return self.model.param_specs()

    def abstract_params(self) -> Dict[str, Any]:
        """The parameter tree as meta tensors: the specs' shapes in
        ``self.dtype``, holding no memory (the reference's
        ``ShapeDtypeStruct`` stand-ins)."""
        return map_tree(lambda s: torch.empty(s.shape, dtype=self.dtype,
                                              device="meta"),
                        self.param_specs())

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

    def init_cache_axes(self, batch: int, max_seq: Optional[int] = None):
        """Logical axes of ``init_cache_specs(batch, max_seq)``'s leaves, in
        its tree. The reference's ``init_cache_specs`` returns ``(specs,
        axes)``; the port's returns the specs alone (the engine and the
        tests call it), and this gives the axes. They do not depend on the
        sizes, which are taken for the reference's signature."""
        return self.model.init_cache_axes()

    def _zeros(self, specs):
        return map_specs(lambda s: torch.zeros(s[0], dtype=s[1],
                                               device=self.device), specs)

    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   fill_len: int = 0) -> Dict[str, Any]:
        """A zero timeline cache (the int8 cache's scales, Hymba's and
        xLSTM's recurrent state zero too, xLSTM's stabilizers included)
        with ``len`` = ``fill_len``, on ``self.device``."""
        cache = self._zeros(self.init_cache_specs(batch, max_seq))
        cache["len"].fill_(fill_len)
        return cache

    @property
    def paged_ok(self) -> bool:
        """Paged decode support (dense, MoE and VLM with a plain
        full-attention KV cache); an int8-cache or sliding-window model,
        Hymba's and xLSTM's recurrent state and Whisper keep the timeline
        layout."""
        return self.model.paged_ok

    # -- paged per-slot KV cache (serving hot path) ---------------------------
    def init_paged_cache_specs(self, num_slots: int, num_pages: int,
                               page_size: int, pages_per_slot: int):
        return self.model.init_paged_cache_specs(
            num_slots, num_pages, page_size, pages_per_slot, self.dtype)

    def init_paged_cache(self, num_slots: int, num_pages: int,
                         page_size: int, pages_per_slot: int):
        return self._zeros(self.init_paged_cache_specs(
            num_slots, num_pages, page_size, pages_per_slot))

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

    # -- inputs of a shape cell -------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``(shape, dtype)`` of every model input of a shape cell (the
        reference's ``input_specs``): ``tokens`` (and ``labels`` to train),
        for a VLM ``patches`` [B, P, d] outside decode and ``pos3``
        [B, S, 3], for Whisper ``frames`` [B, encoder_seq, d] outside
        decode. ``torch.empty(shape, dtype=dtype, device="meta")`` makes a
        stand-in that holds no memory."""
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        tok_len = 1 if shape.kind == "decode" else S
        specs: Dict[str, Any] = {"tokens": ((B, tok_len), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((B, S), torch.int32)
        if c.family == VLM:
            if shape.kind != "decode":
                specs["patches"] = ((B, c.num_patches, c.d_model),
                                    self.dtype)
            specs["pos3"] = ((B, tok_len, 3), torch.int32)
        if c.family == ENCDEC and shape.kind != "decode":
            specs["frames"] = ((B, c.encoder_seq, c.d_model), self.dtype)
        return specs

    def input_axes(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Logical axes matching ``input_specs`` (the reference's)."""
        c = self.cfg
        axes: Dict[str, Any] = {"tokens": ("act_batch", None)}
        if shape.kind == "train":
            axes["labels"] = ("act_batch", None)
        if c.family == VLM:
            if shape.kind != "decode":
                axes["patches"] = ("act_batch", None, "act_embed")
            axes["pos3"] = ("act_batch", None, None)
        if c.family == ENCDEC and shape.kind != "decode":
            axes["frames"] = ("act_batch", None, "act_embed")
        return axes

    def make_inputs(self, shape: ShapeConfig,
                    generator: torch.Generator) -> Dict[str, Any]:
        """Concrete (small) inputs matching ``input_specs``, drawn from
        ``generator`` (on ``self.device``) in the specs' order, as the
        reference draws them: integers uniform in [0, vocab) for tokens and
        labels and in [0, 4) otherwise, floats standard normal in f32, then
        cast."""
        out = {}
        for name, (shp, dt) in self.input_specs(shape).items():
            if not dt.is_floating_point:
                hi = self.cfg.vocab_size if name in ("tokens", "labels") \
                    else 4
                out[name] = torch.randint(0, hi, shp, generator=generator,
                                          device=self.device, dtype=dt)
            else:
                out[name] = torch.randn(shp, generator=generator,
                                        device=self.device,
                                        dtype=torch.float32).to(dt)
        return out


BUILDERS: Dict[str, Callable] = {
    DENSE: lambda cfg, max_seq, remat, q: build_dense(cfg, remat,
                                                      cache_quant=q),
    MOE: lambda cfg, max_seq, remat, q: build_moe(cfg, remat, cache_quant=q),
    SSM: lambda cfg, max_seq, remat, q: build_xlstm(
        cfg, remat, state_dtype=torch.bfloat16 if q else torch.float32),
    HYBRID: lambda cfg, max_seq, remat, q: build_hymba(cfg, remat),
    VLM: lambda cfg, max_seq, remat, q: build_vlm(cfg, remat, cache_quant=q),
    ENCDEC: lambda cfg, max_seq, remat, q: WhisperModel(cfg, max_seq, remat),
}


def build_model(cfg: ArchConfig, *,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16,
                remat: bool = True, max_seq: int = 4096,
                cache_quant: bool = False) -> ModelAPI:
    """The family's builder (``BUILDERS``, keyed by family as the
    reference's). ``device`` defaults to ``cuda`` and raises without a
    card; pass ``device="cpu"`` for the CPU reference path. ``remat``
    recomputes each block in the backward of ``loss_fn`` (the reference's
    default). ``max_seq`` is the timeline cache's default horizon (and the
    length of Whisper's learned decoder positions); ``cache_quant`` keeps
    the timeline cache in int8 (dense, MoE and VLM; no paged cache then,
    as in the reference), xLSTM's recurrent state in bf16 (its mLSTM
    stabilizer in f32); Hymba and Whisper ignore it, as the reference's
    do."""
    if cfg.family not in BUILDERS:
        raise ValueError(f"no builder for family {cfg.family!r}")
    dev = resolve_device(device)
    return ModelAPI(cfg, BUILDERS[cfg.family](cfg, max_seq, remat,
                                              cache_quant),
                    dev, dtype, max_seq)
