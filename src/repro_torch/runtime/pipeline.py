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

Both KV layouts run here: the paged pools (``build(paged=True)``) and the
reference's shared-position timeline (``build(paged=False)``: a cache
body ``[L, B, KVH, S, D]``, one ``len`` for every row and a per-slot
``start`` mask, ``per_slot_start``).

What the reference does for sharding over pods and the port does not copy
on one card:

* the staged ``[S, bps, ...]`` parameter and cache layout with its padding
  masks: the pools and the timeline body keep one layer per row of their
  leading dim and a stage is a range of layers, so staging a cache is
  the identity and ``restage_cache`` on a live boundary swap moves
  nothing;
* the warm-up and drain ticks, whose outputs the reference masks out: only
  the ``nm * S`` valid (microbatch, stage) pairs run, in tick order, which
  makes ``nm * (S - 1)`` seals and as many unseals per step;
* the ``ppermute`` ring between pods: a sealed payload stays on the card
  between its seal and its unseal.

Each stage reads and writes only its own layers of the shared pools, for
its microbatch's block-table rows; ``seq_lens`` advance once per step,
for every row that holds a sequence. On the timeline a stage writes its
layers' rows of its microbatch at the shared position ``len``, which
advances once per step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops as K
from repro_torch.models.api import ModelAPI


def pipeline_applicable(api: ModelAPI) -> bool:
    """The reference's test: a model of one homogeneous segment (not
    moonshot's dense stem ahead of its MoE blocks)."""
    model = api.model
    return hasattr(model, "segments") and len(model.segments) == 1


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
        charged, not how a stage runs. The spec places the served
        segment's blocks (the engine's ``block_profiles``)."""
        n = api.model.served_segment.n
        assert spec.num_layers == n, (spec.num_layers, n)
        return cls(api, num_stages=spec.num_segments,
                   num_microbatches=num_microbatches,
                   stage_blocks=spec.stage_sizes(),
                   stage_devices=spec.devices(), **kw)

    def __post_init__(self):
        assert pipeline_applicable(self.api), \
            "pipelined serve needs a single homogeneous segment"
        n, S = self.api.model.served_segment.n, self.num_stages
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

    # -- the timeline cache's staging (the identity on one card) -------------
    def stage_cache(self, cache):
        """A timeline cache dict -> the staged pair ``(body, len)``. The
        body keeps its ``[L, B, ...]`` layout: stage s reads its layer range
        of it."""
        return cache[self.api.model.served_segment.name], cache["len"]

    def unstage_cache(self, staged, new_len):
        """The inverse of ``stage_cache``."""
        return {self.api.model.served_segment.name: staged, "len": new_len}

    def restage_cache(self, cache, new_dec: "PipelinedDecoder"):
        """Carry a cache over to ``new_dec``'s boundaries (a live re-plan
        swap): the paged cache dict, or the timeline's staged tuple
        ``(body, len)`` or ``(body, len, start)``, returned in the same
        form. Pools and bodies keep one layer per row of their leading dim
        whatever the stage layout, so nothing moves: the cache is valid
        under the new ranges as it is."""
        n = self.api.model.served_segment.n
        assert new_dec.api.model.served_segment.n == n
        return cache

    # -- one stage on one microbatch (the tick body and the probe) ----------
    def _pos3(self, pos: torch.Tensor, rows: int):
        """Text-only M-RoPE positions (p, p, p) [rows, 1, 3] at ``pos`` (a
        per-row [rows] or one shared position), as the reference's stage
        run builds them; None for RoPE."""
        if self.api.cfg.pos_type != "mrope":
            return None
        return pos.reshape(-1, 1, 1).expand(rows, 1, 3)

    def _stage_run(self, params, pools, s: int, x: torch.Tensor,
                   bt: torch.Tensor, sl: torch.Tensor) -> torch.Tensor:
        start, end = self.ranges[s]
        return self.api.model.decode_blocks(params, pools, x, bt, sl,
                                            start, end,
                                            pos3=self._pos3(sl, x.shape[0]))

    def _timeline_stage_run(self, params, body, s: int, x: torch.Tensor,
                            cache_len: torch.Tensor, start=None,
                            rows: slice = slice(None)) -> torch.Tensor:
        """Stage s's layers on the timeline rows ``rows``, carrying every
        layer's cache tree (a Hymba layer's rolling KV, conv window and SSM
        state, an xLSTM pair's recurrent state) in place."""
        lo, hi = self.ranges[s]
        return self.api.model.decode_timeline_blocks(
            params, body, x, cache_len, start, lo, hi, rows,
            pos3=self._pos3(cache_len, x.shape[0]))

    def build_stage_probe(self, paged: bool = True) -> Callable:
        """A single-stage runner for per-stage wall-time telemetry, which
        runs stage s's layer range on one microbatch exactly as a tick
        would (minus the seal) and returns its output. The caller times it
        (the engine: CUDA events on the card, the host clock on the CPU).
        The probe must leave the serving state as it found it.

        ``paged=True``: ``probe(params, pools, s, x, bt, sl)``; the caller
        passes block-table rows of the null page, so every K/V write is
        dropped and every read sees the zero page, over as many pages as
        the live lengths reach. ``paged=False`` (the timeline):
        ``probe(params, body, s, x, cache_len)``; the caller passes a
        scratch body of one microbatch's rows, so the writes land there
        and the attention covers the live horizon (its cost does not
        depend on what the cache holds)."""
        if paged:
            return self._stage_run
        return self._timeline_stage_run

    # -- the step -------------------------------------------------------------
    def build(self, paged: bool = True,
              per_slot_start: bool = True) -> Callable:
        """``step_fn(params, cache, batch, key) -> (logits, cache)``;
        ``batch["tokens"]`` is [B, 1]; ``key`` is the uint32 boundary key
        of this step, a one-element integer tensor on the device (the
        engine's, which a captured step reads at every replay) or an int
        (eager callers). Returns f32 logits [B, V] and the cache, updated
        in place.

        ``paged=True``: ``cache`` is the paged cache dict of
        ``ModelAPI.init_paged_cache`` (pools ``[L, N, KVH, Pg, D]``,
        ``block_tables`` [B, MP], ``seq_lens`` [B]). Demand paging / COW:
        the engine backs every row's next write position with a private
        page before the step, so the stages never write a shared page;
        reads gather freely across shared pages.

        ``paged=False``: ``cache`` is the staged timeline tuple
        ``(body, len, start)`` with ``start`` the per-slot [B] first valid
        positions (``per_slot_start``, the engine's continuous-batching
        mask), or ``(body, len)`` without it; ``len`` advances by one."""
        if not paged:
            return self._build_timeline(per_slot_start)
        stage_run = self._stage_run
        ticks = self._ticks()

        def step_fn(params, cache, batch, key):
            bt, sl = cache["block_tables"], cache["seq_lens"]
            pools = cache[self.api.model.served_segment.name]
            logits = ticks(params, batch["tokens"], key,
                           lambda s, x, rows: stage_run(
                               params, pools, s, x, bt[rows], sl[rows]))
            sl.copy_(torch.where(sl > 0, sl + 1, sl))
            return logits, cache

        return step_fn

    def _build_timeline(self, per_slot_start: bool) -> Callable:
        """``build(paged=False)``: the tick loop over the timeline cache.
        Microbatch m's rows of every stage's layers sit at the shared
        position ``len``; stage s runs its layer range on them and seals
        its boundary as on the paged layout."""
        stage_run = self._timeline_stage_run
        ticks = self._ticks()

        def step_fn(params, cache, batch, key):
            if per_slot_start:
                body, cache_len, start = cache
            else:
                (body, cache_len), start = cache, None

            def run(s, x, rows):
                st = None if start is None else start[rows]
                return stage_run(params, body, s, x, cache_len, st, rows)

            logits = ticks(params, batch["tokens"], key, run)
            cache_len.add_(1)
            return logits, cache

        return step_fn

    def _ticks(self) -> Callable:
        """The tick loop of one step, for either layout:
        ``ticks(params, tokens, key, run) -> f32 logits [B, V]``, where
        ``run(s, x, rows)`` runs stage s on microbatch ``rows`` (a slice of
        the batch). Microbatch m leaves stage s at tick ``t = m + s``,
        sealed under ``key`` and the counter of tick t + 1; stage 0 embeds,
        the last stage applies the head."""
        api, model = self.api, self.api.model
        S, nm = self.num_stages, self.num_microbatches
        seal_on = self.seal_boundary
        # _leaf_counter(t, 0) for every tick t: tick t seals under t + 1
        ctrs = sealing.leaf_counters(nm + S, api.device) if seal_on else None

        def ticks(params, tokens, key, run):
            B = tokens.shape[0]                            # tokens [B, 1]
            assert B % nm == 0, (B, nm)
            B_mb = B // nm
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
                    h = run(s, x, rows)
                    if s == S - 1:
                        logits[m] = model.head(params, h)
                    elif seal_on:
                        inflight[m] = K.seal(h.reshape(-1, d), key,
                                             ctrs[t + 1:t + 2])
                    else:
                        inflight[m] = h
            return torch.cat(logits)

        return ticks
