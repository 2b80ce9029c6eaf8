"""Serdab pipelined serving: stages in sequence on one card, or one stage
per rank.

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
on one card (without ``mesh``):

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

With ``mesh=`` (a ``DeviceMesh`` of the world's ranks from ``make_mesh``
inside ranks that ``launch.ranks.spawn`` started: axes ``pod`` and
``data``, ``pod`` of ``num_stages``) stage s runs on the ranks of pod s,
the reference's layout. ``stage_params`` / ``stage_cache`` /
``stage_paged_cache`` keep a rank's own layers only (and the embedding on
stage 0, the final norm and head on the last). Microbatch m still meets
stage s at tick ``m + s``: stage s takes its microbatches in order,
receives each from stage s - 1, runs it, and posts it to stage s + 1
sealed under the step's key and the counter of tick ``m + s + 1`` (raw
without sealing) as a message (``launch.ranks``: through pinned host
memory under gloo), so a payload leaves its enclave only as cipher text.
The ``data`` ranks of a pod split each microbatch's rows evenly: data
rank d takes the d-th block of ``B_mb / data`` rows and seals it under
the leaf counter ``_leaf_counter(t + 1, d)``, so two data ranks never
share a (key, counter) pair (with one data rank the counters, and the
cipher, are the one-card path's). A data rank keeps its stage's whole
cache and reads and writes only its rows (its rows' pages in the pools).
The last stage's logits reach every rank (a broadcast over ``pod``, then a
gather over ``data``), so the step returns the one-card path's [B, V].
The rank step runs eagerly: a step that messages through the host is not
captured in a CUDA graph.

Two more pieces serve an engine whose stages are ranks
(``ServingEngine(mesh=)``), with one pod rank per stage and no data axis:

* ``rank_forward`` runs this rank's layers of a prefill (one-shot, packed,
  chunked or one token) between its neighbours: it takes the hidden
  state from stage s - 1 and posts its own to stage s + 1, each crossing
  sealed with the lossless page cipher under a counter of its own
  (``sealing.crossing_seq``), never with the int8 seal: the reference runs
  its prefill on the whole params, so a lossy crossing would change its
  streams. Unsealed with ``seal_boundary`` off, as the decode boundary.
  The last stage's logits reach every rank.
* ``restage_cache`` on a live re-plan moves the layers that change owner
  between the ranks: their pool rows (paged) or body rows (timeline) go
  sealed with the page cipher under counters of their own
  (``sealing.restage_seq``); what a rank keeps stays in place. The result
  is the cache staged directly under the new boundaries.

Each stage reads and writes only its own layers of the shared pools, for
its microbatch's block-table rows; ``seq_lens`` advance once per step,
for every row that holds a sequence. On the timeline a stage writes its
layers' rows of its microbatch at the shared position ``len``, which
advances once per step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops as K
from repro_torch.kernels.seal import int_dtype_of
from repro_torch.launch import ranks as RK
from repro_torch.models.api import ModelAPI
from repro_torch.tree import leaves, map_tree


# restage sequence numbers one restage may take (``restage_cache``)
RESTAGE_SEQS = 256


def _cipher_dtype(t: torch.Tensor) -> torch.dtype:
    """The float type whose bits the page cipher moves ``t`` as: its own
    for f32 and bf16, bf16 (two bytes an element) for anything else."""
    return t.dtype if t.dtype in (torch.float32, torch.bfloat16) \
        else torch.bfloat16


def _cipher_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [rows, ...] as a contiguous 2D float view of its bits."""
    t = t.contiguous()
    if t.dtype in (torch.float32, torch.bfloat16):
        return t.reshape(t.shape[0], -1)
    return t.view(torch.uint8).reshape(t.shape[0], -1).view(torch.bfloat16)


def _cipher_like(t: torch.Tensor, rows: int) -> torch.Tensor:
    """An empty cipher of ``rows`` layers of ``t``'s kind (a receive's
    shape and type)."""
    per = _cipher_rows(t[:1]).shape[1]
    return torch.empty((rows, per), device=t.device,
                       dtype=int_dtype_of(_cipher_dtype(t)))


def _from_cipher(rows: torch.Tensor, like: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The inverse of ``_cipher_rows``: opened rows back to ``n`` layers
    shaped and typed as ``like``'s."""
    shape = (n,) + tuple(like.shape[1:])
    if like.dtype in (torch.float32, torch.bfloat16):
        return rows.reshape(shape)
    return rows.view(torch.uint8).view(like.dtype).reshape(shape)


def pipeline_applicable(api: ModelAPI) -> bool:
    """The reference's test: a model of one homogeneous segment (not
    moonshot's dense stem ahead of its MoE blocks)."""
    model = api.model
    return hasattr(model, "segments") and len(model.segments) == 1


@dataclasses.dataclass
class PipelinedDecoder:
    """Builds the pipelined decode step of one stage layout: with no mesh
    the stages run one after another on ``api.device``; with a mesh of
    ranks this rank runs its pod's stage (see the module's docstring)."""

    api: ModelAPI
    num_stages: int
    num_microbatches: int
    seal_boundary: bool = True
    stage_blocks: Optional[Sequence[int]] = None   # per-stage block counts
    stage_devices: Optional[Sequence[str]] = None  # per-stage device names
    mesh: Any = None                               # a DeviceMesh of ranks

    @classmethod
    def from_spec(cls, api: ModelAPI, spec, num_microbatches: int, *,
                  mesh=None, **kw) -> "PipelinedDecoder":
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
                   stage_devices=spec.devices(), mesh=mesh, **kw)

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
        if self.mesh is not None:
            self._place_on_ranks()

    # -- a stage per rank ----------------------------------------------------
    def _place_on_ranks(self) -> None:
        from repro_torch.launch.mesh import rank_axes
        from repro_torch.sharding import rules as R
        sizes = R.mesh_axis_sizes(self.mesh)
        if not R.is_device_mesh(self.mesh) \
                or any(k > 1 for a, k in sizes.items()
                       if a not in ("pod", "data")) \
                or sizes.get("pod") != self.num_stages:
            raise ValueError(
                f"PipelinedDecoder(mesh=): a DeviceMesh of ranks over pod "
                f"(= num_stages {self.num_stages}) and data, got {sizes} "
                f"(a model axis is ROADMAP item 10d)")
        ax = rank_axes(self.mesh)
        self.stage, self.data = ax.index("pod"), ax.index("data")
        self.num_data = ax.size("data")
        self._pod_group, self._data_group = ax.group("pod"), ax.group("data")
        self._pod_ranks = RK.group_ranks(self._pod_group)
        self.staging = RK.Staging()

    def _local(self, s: int) -> Tuple[int, int]:
        """Stage s's layer range in the params and cache it runs on: its
        range of the whole stack on one card, its own layers (from 0) on a
        rank."""
        if self.mesh is None:
            return self.ranges[s]
        return 0, self.stage_counts[s]

    def _cut(self, tree, device=None):
        lo, hi = self.ranges[self.stage]
        return map_tree(lambda t: t[lo:hi].to(device or t.device,
                                              copy=True), tree)

    def stage_params(self, params, device=None):
        """This rank's params: its stage's layers of the served segment,
        the embedding on stage 0 (and on the last stage when the head is
        tied to it), the final norm and head on the last stage, anything
        else (a frontend) on stage 0; copied to ``device`` when given (a
        rank engine cuts them from its host copy of the whole tree). The
        whole tree on one card."""
        if self.mesh is None:
            return params
        seg = self.api.model.served_segment.name
        first, last = self.stage == 0, self.stage == self.num_stages - 1
        keep = {"embed": first or (last and self.api.cfg.tie_embeddings),
                "ln_f": last, "head": last}
        return {k: self._cut(v, device) if k == seg
                else map_tree(lambda t: t.to(device or t.device), v)
                for k, v in params.items()
                if k == seg or keep.get(k, first)}

    def stage_paged_cache(self, cache):
        """This rank's paged cache: its stage's layers of the pools, the
        whole block tables and seq_lens. The dict itself on one card."""
        if self.mesh is None:
            return cache
        seg = self.api.model.served_segment.name
        return dict(cache, **{seg: self._cut(cache[seg])})

    # -- the timeline cache's staging (the identity on one card) -------------
    def stage_cache(self, cache):
        """A timeline cache dict -> the staged pair ``(body, len)``. The
        body keeps its ``[L, B, ...]`` layout: stage s reads its layer range
        of it. On a rank, the body holds the stage's layers only."""
        body = cache[self.api.model.served_segment.name]
        return (body if self.mesh is None else self._cut(body)), cache["len"]

    def unstage_cache(self, staged, new_len):
        """The inverse of ``stage_cache``."""
        return {self.api.model.served_segment.name: staged, "len": new_len}

    def restage_cache(self, cache, new_dec: "PipelinedDecoder", *,
                      key: int = 0, seq: int = 0):
        """Carry a cache over to ``new_dec``'s boundaries (a live re-plan
        swap): the paged cache dict, or the timeline's staged tuple
        ``(body, len)`` or ``(body, len, start)``, returned in the same
        form. On one card pools and bodies keep one layer per row of their
        leading dim whatever the stage layout, so nothing moves: the cache
        is valid under the new ranges as it is. On ranks this rank's
        layers of the pools or body become its layers under the new
        ranges (``_move_layers``), sealed under ``key`` and the restage
        sequence numbers ``seq``, ``seq + 1``, ... (at most
        ``RESTAGE_SEQS`` of them); block tables, seq_lens, ``len`` and
        ``start`` are whole on every rank and stay."""
        n = self.api.model.served_segment.n
        assert new_dec.api.model.served_segment.n == n
        if self.mesh is None:
            return cache
        assert new_dec.mesh is not None and new_dec.stage == self.stage
        seg = self.api.model.served_segment.name
        if isinstance(cache, dict):
            return dict(cache, **{seg: self._move_layers(cache[seg], new_dec,
                                                         key, seq)})
        return (self._move_layers(cache[0], new_dec, key, seq),) + \
            tuple(cache[1:])

    def _moves(self, new_dec: "PipelinedDecoder"):
        """Every (source stage, destination stage, first layer, end layer)
        of a restage to ``new_dec``: the layers the source owns now and the
        destination owns after, in one order every rank computes."""
        out = []
        for a, (alo, ahi) in enumerate(self.ranges):
            for b, (blo, bhi) in enumerate(new_dec.ranges):
                lo, hi = max(alo, blo), min(ahi, bhi)
                if a != b and lo < hi:
                    out.append((a, b, lo, hi))
        return out

    def _move_layers(self, tree, new_dec: "PipelinedDecoder", key: int,
                     seq: int):
        """This rank's tree of stacked layer leaves (its old range) ->
        the same tree over its new range: the layers it keeps stay, the
        ones it loses go to their new owners and the ones it gains come
        from their old owners, each leaf's slab of a message sealed with
        the page cipher (its bytes viewed as bf16 rows when it is not a
        float: an int8 cache) under its own restage counter."""
        s = self.stage
        (olo, ohi), (nlo, nhi) = self.ranges[s], new_dec.ranges[s]
        flat = leaves(tree)
        moves = self._moves(new_dec)
        assert len(moves) * len(flat) <= RESTAGE_SEQS, \
            (len(moves), len(flat))

        def ctr(m: int, j: int):
            return sealing._swap_counter(
                sealing.restage_seq(seq + m * len(flat) + j), 0)

        outgoing, incoming = [], []
        for m, (a, b, lo, hi) in enumerate(moves):
            if a == s:
                outgoing.append((self._pod_ranks[b], [
                    K.seal_bits(_cipher_rows(t[lo - olo:hi - olo]), key,
                                ctr(m, j)) for j, t in enumerate(flat)]))
            elif b == s:
                incoming.append((self._pod_ranks[a], [
                    _cipher_like(t, hi - lo) for t in flat]))
        got = iter(RK.transfer(self.staging, outgoing, incoming,
                               self._pod_group, tag="restage"))
        pieces = {}                        # first layer -> its leaves
        for m, (a, b, lo, hi) in enumerate(moves):
            if b == s:
                pieces[lo] = [_from_cipher(K.unseal_bits(
                    c, key, ctr(m, j), out_dtype=_cipher_dtype(t)), t,
                    hi - lo) for j, (c, t) in enumerate(zip(next(got),
                                                            flat))]
        keep_lo, keep_hi = max(olo, nlo), min(ohi, nhi)
        if keep_lo < keep_hi:
            pieces[keep_lo] = [t[keep_lo - olo:keep_hi - olo] for t in flat]
        new = [torch.cat([pieces[lo][j] for lo in sorted(pieces)])
               for j in range(len(flat))]
        assert all(t.shape[0] == nhi - nlo for t in new), (nlo, nhi)
        it = iter(new)
        return map_tree(lambda _: next(it), tree)

    # -- a prefill stage on a rank --------------------------------------------
    def rank_forward(self, run: Callable, shape: Tuple[int, ...],
                     logits_rows: int, key, seq: int) -> torch.Tensor:
        """This rank's layers of one prefill call between its neighbours:
        ``run(x)`` runs them, with ``x`` the hidden state [*shape, d_model]
        from stage s - 1 (None on stage 0, which embeds), and returns what
        leaves them: the hidden state, or the f32 logits [logits_rows, V]
        on the last stage. The hidden state crossing from stage s to s + 1
        is sealed with the page cipher under ``key`` and the crossing
        sequence number ``seq + s`` (``sealing.crossing_seq``; one call
        takes ``num_stages - 1`` of them), raw with ``seal_boundary`` off.
        Returns the last stage's logits on every rank. A rank that sends a
        crossing keeps its host ms (from its hidden state ready on the
        device to the send complete: seal, staging, transport) and bytes
        in ``last_crossing``."""
        api, S, s = self.api, self.num_stages, self.stage
        d, V = api.cfg.d_model, api.cfg.vocab_size
        dev = api.device

        def ctr(i: int):
            return sealing._swap_counter(sealing.crossing_seq(seq + i), 0)

        x = None
        if s > 0:
            rows = math.prod(shape)
            like = torch.empty((rows, d), device=dev, dtype=(
                int_dtype_of(api.dtype) if self.seal_boundary
                else api.dtype))
            got = RK.recv(self.staging, [like], self._pod_ranks[s - 1],
                          self._pod_group, tag="hidden_in").wait()[0]
            if self.seal_boundary:
                got = K.unseal_bits(got, key, ctr(s - 1),
                                    out_dtype=api.dtype)
            x = got.reshape(*shape, d)
        out = run(x)
        if s < S - 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0, sent0 = time.perf_counter(), self.staging.sent
            h = out.reshape(-1, d)
            payload = K.seal_bits(h, key, ctr(s)) if self.seal_boundary \
                else h
            RK.send(self.staging, [payload], self._pod_ranks[s + 1],
                    self._pod_group, tag="hidden_out").wait()
            self.last_crossing = ((time.perf_counter() - t0) * 1e3,
                                  self.staging.sent - sent0)
            out = torch.empty((logits_rows, V), dtype=torch.float32,
                              device=dev)
        RK.broadcast(self.staging, out, self._pod_ranks[-1], self._pod_group,
                     tag="prefill_logits")
        return out

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
        start, end = self._local(s)
        return self.api.model.decode_blocks(params, pools, x, bt, sl,
                                            start, end,
                                            pos3=self._pos3(sl, x.shape[0]))

    def _timeline_stage_run(self, params, body, s: int, x: torch.Tensor,
                            cache_len: torch.Tensor, start=None,
                            rows: slice = slice(None)) -> torch.Tensor:
        """Stage s's layers on the timeline rows ``rows``, carrying every
        layer's cache tree (a Hymba layer's rolling KV, conv window and SSM
        state, an xLSTM pair's recurrent state) in place."""
        lo, hi = self._local(s)
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
        ticks = self._ticks() if self.mesh is None else self._rank_ticks()

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
        ticks = self._ticks() if self.mesh is None else self._rank_ticks()

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

    def _rank_ticks(self) -> Callable:
        """``_ticks`` on a rank: this rank's stage over the microbatches in
        order, its rows of each (``data`` ranks split them), inputs
        received from the previous stage's rank of this data index and
        outputs posted to the next one's; then the last stage's logits to
        every rank."""
        api, model = self.api, self.api.model
        S, nm, s = self.num_stages, self.num_microbatches, self.stage
        D, d = self.num_data, self.data
        seal_on = self.seal_boundary
        ctrs = sealing.leaf_counters(nm + S, api.device, leaf=d) \
            if seal_on else None
        prev = self._pod_ranks[s - 1] if s > 0 else None
        nxt = self._pod_ranks[s + 1] if s < S - 1 else None
        staging, pod_g = self.staging, self._pod_group
        dm, V = api.cfg.d_model, api.cfg.vocab_size

        def ticks(params, tokens, key, run):
            B = tokens.shape[0]                            # tokens [B, 1]
            assert B % (nm * D) == 0, (B, nm, D)
            B_mb = B // nm
            b = B_mb // D
            dev = tokens.device
            if seal_on:
                likes = (torch.empty((b, dm), dtype=torch.uint8, device=dev),
                         torch.empty((b, 1), dtype=torch.float32,
                                     device=dev))
            else:
                likes = (torch.empty((b, 1, dm), dtype=api.dtype,
                                     device=dev),)
            logits = torch.empty((nm, b, V), dtype=torch.float32,
                                 device=dev)
            posted = []
            for m in range(nm):
                t = m + s                          # the reference's tick
                rows = slice(m * B_mb + d * b, m * B_mb + (d + 1) * b)
                if s == 0:
                    x = model.embed(params, tokens[rows])
                else:
                    got = RK.recv(staging, likes, prev, pod_g,
                                  tag="in").wait()
                    x = K.unseal(got[0], got[1], key, ctrs[t:t + 1],
                                 out_dtype=api.dtype).reshape(b, 1, dm) \
                        if seal_on else got[0]
                h = run(s, x, rows)
                if nxt is None:
                    logits[m] = model.head(params, h)
                else:
                    payload = K.seal(h.reshape(-1, dm), key,
                                     ctrs[t + 1:t + 2]) if seal_on else (h,)
                    posted.append(RK.send(staging, payload, nxt, pod_g,
                                          tag=("out", m)))
            for p in posted:
                p.wait()
            RK.broadcast(staging, logits, self._pod_ranks[-1], pod_g,
                         tag="logits")
            every = logits[None] if D == 1 else RK.all_gather(
                staging, logits, self._data_group, tag="logits")
            # every: [D, nm, b, V]; row m * B_mb + d * b + j is [d, m, j]
            return every.transpose(0, 1).reshape(B, V)

        return ticks
