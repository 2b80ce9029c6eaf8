"""Serdab pipelined serving, stages in sequence on one card.

Port of ``repro/runtime/pipeline.py``. The block stack is split into
``num_stages`` contiguous stages (block counts from the placement
solver, uneven ones included) and the decode batch into
``num_microbatches`` microbatches: rows ``[m * B_mb, (m + 1) * B_mb)``
form microbatch m, with ``B_mb = num_slots / num_microbatches``.
Microbatch m leaves stage s at tick ``t = m + s``; its ``[B_mb, 1, d]``
activation is sealed there under the step's key and the counter
``_leaf_counter(t + 1, 0)`` (int8 quantize + keystream XOR, the paper's
enclave-to-enclave discipline, as the reference's
``seal_array(h, key, t + 1)``) and opened by stage s + 1 under the same
pair. The step takes its key as a one-element device tensor, and the
per-tick counters, fixed for a layout, are built once as a device tensor
(``sealing.leaf_counters``), so the step can be captured in a CUDA
graph: each replay seals under the key the engine copied in for it.
Stage 0 embeds instead of unsealing; the last stage applies the final
norm and the f32 head, unsealed.

What the reference does for sharding over pods and the port does not copy
on one card:

* the staged ``[S, bps, ...]`` parameter and pool layout with its padding
  masks: the pools stay ``[L, N, KVH, Pg, D]`` and a stage is a range of
  layers, so ``restage_cache`` on a live boundary swap moves no pages;
* the warm-up and drain ticks, whose outputs the reference masks out: only
  the ``nm * S`` valid (microbatch, stage) pairs run, in tick order, which
  makes ``nm * (S - 1)`` seals and as many unseals per step;
* the ``ppermute`` ring between pods: a sealed payload stays on the card
  between its seal and its unseal.

Each stage reads and writes only its own layers of the shared pools, for
its microbatch's block-table rows; ``seq_lens`` advance once per step,
for every row that holds a sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops as K
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import SEGMENT


def pipeline_applicable(api: ModelAPI) -> bool:
    """The port's dense stack is one homogeneous block segment."""
    return hasattr(api.model, "decode_blocks")


@dataclasses.dataclass
class PipelinedDecoder:
    """Builds the pipelined decode step of one stage layout (no mesh: the
    stages run one after another on ``api.device``)."""

    api: ModelAPI
    num_stages: int
    num_microbatches: int
    seal_boundary: bool = True
    stage_blocks: Optional[Sequence[int]] = None   # per-stage block counts
    stage_devices: Optional[Sequence[str]] = None  # per-stage device names

    @classmethod
    def from_spec(cls, api: ModelAPI, spec, num_microbatches: int,
                  **kw) -> "PipelinedDecoder":
        """A decoder straight from a planner ``PlacementSpec``: stage s runs
        segment s (``spec.segments[s]``). The spec's device order is the
        pipeline order; the trust domain changes what the cost model
        charged, not how a stage runs."""
        n = api.cfg.num_layers
        assert spec.num_layers == n, (spec.num_layers, n)
        return cls(api, num_stages=spec.num_segments,
                   num_microbatches=num_microbatches,
                   stage_blocks=spec.stage_sizes(),
                   stage_devices=spec.devices(), **kw)

    def __post_init__(self):
        assert pipeline_applicable(self.api), \
            "pipelined serve needs a single homogeneous segment"
        n, S = self.api.cfg.num_layers, self.num_stages
        if self.stage_blocks is None:
            assert n % S == 0, \
                f"{n} blocks not divisible into {S} stages; pass " \
                f"stage_blocks= for uneven boundaries"
            counts = (n // S,) * S
        else:
            counts = tuple(int(c) for c in self.stage_blocks)
            assert len(counts) == S, (counts, S)
            assert all(c > 0 for c in counts), counts
            assert sum(counts) == n, (counts, n)
        if self.stage_devices is not None:
            self.stage_devices = tuple(self.stage_devices)
            assert len(self.stage_devices) == S, (self.stage_devices, S)
        self.stage_counts = counts
        starts = [0]
        for c in counts:
            starts.append(starts[-1] + c)
        # stage s runs layers [ranges[s][0], ranges[s][1])
        self.ranges: Tuple[Tuple[int, int], ...] = tuple(
            (starts[s], starts[s + 1]) for s in range(S))

    def restage_cache(self, cache, new_dec: "PipelinedDecoder"):
        """Carry the paged cache over to ``new_dec``'s boundaries (a live
        re-plan swap). The pools keep one layer per row of their leading
        dim whatever the stage layout, so nothing moves: the cache is valid
        under the new ranges as it is."""
        assert new_dec.api.cfg.num_layers == self.api.cfg.num_layers
        return cache

    # -- one stage on one microbatch (the tick body and the probe) ----------
    def _stage_run(self, params, pools, s: int, x: torch.Tensor,
                   bt: torch.Tensor, sl: torch.Tensor) -> torch.Tensor:
        start, end = self.ranges[s]
        return self.api.model.decode_blocks(params, pools, x, bt, sl,
                                            start, end)

    def build_stage_probe(self, paged: bool = True) -> Callable:
        """A single-stage runner for per-stage wall-time telemetry:
        ``probe(params, pools, s, x, bt, sl)`` runs stage s's layer range
        on one microbatch exactly as a tick would (minus the seal) and
        returns its output. The caller times it (the engine: CUDA events
        on the card, the host clock on the CPU). The probe must leave the
        serving state as it found it, so the caller passes block-table
        rows of the null page: every K/V write is dropped and every read
        sees the zero page, over as many pages as the live lengths
        reach."""
        if not paged:
            raise NotImplementedError(
                "the timeline KV layout is not ported; build_stage_probe "
                "takes paged=True")
        return self._stage_run

    # -- the step -------------------------------------------------------------
    def build(self, paged: bool = True) -> Callable:
        """``step_fn(params, cache, batch, key) -> (logits, cache)``.
        ``cache`` is the paged cache dict of ``ModelAPI.init_paged_cache``
        (pools ``[L, N, KVH, Pg, D]``, ``block_tables`` [B, MP], ``seq_lens``
        [B]), updated in place; ``batch["tokens"]`` is [B, 1]; ``key`` is
        the uint32 boundary key of this step, a one-element integer tensor
        on the device (the engine's, which a captured step reads at every
        replay) or an int (eager callers). Returns f32 logits [B, V].

        Demand paging / COW: the engine backs every row's next write
        position with a private page before the step, so the stages never
        write a shared page; reads gather freely across shared pages."""
        if not paged:
            raise NotImplementedError(
                "the timeline KV layout is not ported; build takes "
                "paged=True")
        api, model = self.api, self.api.model
        S, nm = self.num_stages, self.num_microbatches
        seal_on = self.seal_boundary
        stage_run = self._stage_run
        # _leaf_counter(t, 0) for every tick t: tick t seals under t + 1
        ctrs = sealing.leaf_counters(nm + S, api.device) if seal_on else None

        def step_fn(params, cache, batch, key):
            tokens = batch["tokens"]                       # [B, 1]
            B = tokens.shape[0]
            assert B % nm == 0, (B, nm)
            B_mb = B // nm
            bt, sl = cache["block_tables"], cache["seq_lens"]
            pools = cache[SEGMENT]
            d = api.cfg.d_model
            inflight: List[Any] = [None] * nm    # each microbatch's boundary
            logits = [None] * nm
            for t in range(nm + S - 1):
                for s in range(S):
                    m = t - s
                    if not 0 <= m < nm:
                        continue        # a warm-up / drain slot: nothing runs
                    rows = slice(m * B_mb, (m + 1) * B_mb)
                    if s == 0:
                        x = model.embed(params, tokens[rows])
                    elif seal_on:
                        cipher, scales = inflight[m]
                        x = K.unseal(cipher, scales, key, ctrs[t:t + 1],
                                     out_dtype=api.dtype).reshape(B_mb, 1, d)
                    else:
                        x = inflight[m]
                    h = stage_run(params, pools, s, x, bt[rows], sl[rows])
                    if s == S - 1:
                        logits[m] = model.head(params, h)
                    elif seal_on:
                        inflight[m] = K.seal(h.reshape(-1, d), key,
                                             ctrs[t + 1:t + 2])
                    else:
                        inflight[m] = h
            sl.copy_(torch.where(sl > 0, sl + 1, sl))
            return torch.cat(logits), cache

        return step_fn

