"""The serving engine's pipelined backends with one stage per pod of
ranks.

``ServingEngine(api, config, params, mesh=mesh, backend="pipelined")``,
called on every rank of a pod x data mesh of ranks (``launch.ranks.spawn``,
then ``launch.mesh.make_mesh((S, D), ("pod", "data"))``; a model axis
below), serves with
stage s on the D data ranks of pod s: the reference's default serve,
where its engine lays a pod's layers of params and page pools on that pod
(its tested layout is 2 x 2). Every rank runs the same host logic
(scheduler, page pool, planner, fault plane) on the same inputs; each
holds only its stage's layers of the params and of the KV on its device,
and a host copy of the whole params tree, from which a live re-plan cuts
its new layers (as the reference's backend keeps its params whole and
restages from them).

What the reference moves inside one program over its mesh is a message
between ranks here, and user data leaves a rank only as cipher text:

* decode: ``PipelinedDecoder(mesh=)``'s tick loop, the boundary sealed
  with the quantizing seal under the step's key (as on one card); the
  data ranks of a pod split each microbatch's rows and then exchange the
  KV entries they wrote, sealed with the page cipher, so that they hold
  one cache (the reference's pools, whole on each data device of a pod);
* admission (one-shot, packed, chunked, one token at a time): each rank
  runs its layers on the whole prompt batch
  (``PipelinedDecoder.rank_forward``); the hidden state crosses to the
  next pod's rank of the same data index sealed with the lossless page
  cipher, the last stage's logits reach every rank; page-table edits,
  forks and slot inserts run on every data rank alike;
* a swap-out seals each pod's layers of the swap rows as its window of
  the rows (``seal_pages(col0=, row_cols=)``), on data rank 0 of the pod
  only: the pods' parts side by side are the one-device payload, byte
  for byte, each part stays on its rank's host with its own digest, and
  each (key, counter) is sealed once. A swap-in after a live re-plan
  first moves the cipher columns to the layers' new owners; then data
  rank 0 of each pod sends its part, still cipher text, to the pod's
  other data ranks, and each unseals it under the same (key, counter);
* a live re-plan moves the layers that change owner between the ranks of
  one data index (``PipelinedDecoder.restage_cache``).

Host decisions agree over the whole world without further messages once
what they read agrees: the stage times are gathered into one vector (data
rank 0 of each pod probes its stage, one pod after another so that two
probes never share a card), the decode step's wall time and each
admission's are global rank 0's, and so is the heartbeat sweep's verdict
(``launch.ranks.share``); a swap-in's integrity verdicts are gathered
from every rank, so one failing part fails it on every rank. The fault
plane draws from its seed on every rank alike.

Warmup (``EngineConfig(warmup=True)``) runs the one-card engine's passes
on every rank in lockstep, so every message pairs up; afterwards each
rank serves with its stage's device work replayed from CUDA graphs and
the messages posted eagerly between replays. A graph cannot hold a
message (``aot`` raises on one inside a managed function), so what is
managed is the work between messages: the decode step's segments
(``PipelinedDecoder.rank_segments``: a microbatch's stage work, the KV
exchange's take and tail), a prefill call's layers with the crossing's
unseal and seal (``crossing_segment``, per bucket), the swap I/O over the
rank's window, the stage probe and the timeline's slot insert, each per
stage layout. Per-call numbers reach them as device tensors: the step
key, the rank's key (made once), the exchange and crossing counters. A
state-neutral warm that needs a neighbour's input takes zeros, not a
message; its counters are drawn like a real call's, and the warmup reset
keeps every sequence running, so no (key, counter) pair that warmup
ciphered is used again. A graph holds addresses, so a rank keeps its
params and KV in slabs sized for the most layers its stage takes over the
planned layout and the warmup's tour: each layout uses a leading view,
and a swap writes the new layers into the slabs in place (``_Ranked``).

The disaggregated pair (``serving/disagg.py::build_disagg(mesh=)``) puts
a prefill-role and a decode-role rank engine on every rank, over one host
tree of params (``host_copy`` keeps a tree already whole on the host, so
both roles share it). Both lay stage s on the ranks of pod s; the prefill
role draws its swaps, crossings, restages and exchanges from sequence
spaces of its own (``sealing``, ``prefill=True``), since both share the
rank's key. A handoff is a swap between the two roles' pools: data rank 0
of each pod seals its pod's window of every page row at export, the
manifest records the prefill role's layer ranges, and at transfer-in the
decode role first moves the cipher columns to their owners under its own
ranges if it has re-planned since (``_relayout``), then forwards the part
to the pod's other data ranks (``_share_part``); its integrity verdicts
are every rank's, as a swap-in's.

Over a ``model`` axis above 1 (a pod x data x model mesh, ROADMAP item
10d, step 5c's first part; the dense and MoE ``StackedLM``) each stage's
layers are split over its pod's model ranks: a rank's slabs hold its
blocks of the params and of the KV (``PipelinedDecoder.model_block`` /
``kv_block``: its KV heads where they divide, else all of them, and on
the timeline its block of the positions there, the distributed
flash-decode), its model code runs under the decoder's ``context()``,
and every function runs eagerly, unmanaged, since its layers message the
model group. Model rank 0 of a stage seals and sends its crossings and
opens the ones it receives for its model group. A swap-out: the model
ranks of (pod, data 0) send their KV heads of the swapped pages to model
rank 0 (``_heads_to_lead``; where the pools hold every KV head, model
rank 0 seals alone), which seals the pod's window as above, so the
payload is the pod x data engine's for the same KV; at swap-in every
rank of the pod receives the cipher (``_share_part`` over the pod's
(data, model) ranks), opens it and keeps its KV heads. The stage probe
runs on every model rank of data rank 0 (model rank 0's time is the
stage's); a live re-plan moves each model rank's blocks to the same
model index of the new owner. Refused by name over a model axis:
warmup in CUDA graphs (a graph cannot hold the model group's
collectives), a disaggregated role, the other families, the int8 cache
(step 5c's rest).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.enclave import sealing
from repro_torch.kernels.seal import int_dtype_of
from repro_torch.launch import ranks as RK
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.runtime.pipeline import RESTAGE_SEQS, PipelinedDecoder
from repro_torch.serving.engine import (PagedPipelinedBackend,
                                        PipelinedDecodeBackend)
from repro_torch.tree import leaves, map_tree

LOG_CAP = 4096          # crossings and restages a backend remembers


def check_rank_mesh(mesh, cfg, backend: str, api) -> None:
    """What a rank engine serves, refused by name otherwise: pod, data and
    model axes, a model axis above 1 for the dense and MoE ``StackedLM``
    (``steps.check_model_axis``), eager and monolithic."""
    from repro_torch.sharding import rules as R
    sizes = R.mesh_axis_sizes(mesh)
    if not R.is_device_mesh(mesh):
        raise ValueError(f"ServingEngine(mesh=): a DeviceMesh of ranks "
                         f"(launch.ranks.spawn, then make_mesh), got "
                         f"{sizes}")
    if backend != "pipelined":
        raise ValueError(f"ServingEngine(mesh=) serves one stage a rank on "
                         f"the pipelined backend, not backend={backend!r}")
    wide = {a: k for a, k in sizes.items()
            if a not in ("pod", "data", "model") and k > 1}
    if wide:
        raise NotImplementedError(
            f"ServingEngine(mesh=): mesh axes {wide}: the engine's ranks "
            f"run over pod, data and model (ROADMAP queue 1, item 10d)")
    m = sizes.get("model", 1)
    if m > 1:
        from repro_torch.runtime.steps import check_model_axis
        check_model_axis(api, m, "ServingEngine(mesh=)")
        if cfg.warmup:
            raise NotImplementedError(
                f"ServingEngine(mesh=, warmup=True) over a model axis of "
                f"{m}: a CUDA graph cannot hold the model group's "
                f"collectives, two a layer (a model-axis step in graphs is "
                f"ROADMAP item 10d, step 5c)")
        if cfg.disagg_role:
            raise NotImplementedError(
                f"ServingEngine(mesh=, disagg_role={cfg.disagg_role!r}) "
                f"over a model axis of {m}: the disaggregated pair over "
                f"a model axis is ROADMAP item 10d, step 5c")
    if sizes.get("pod") != cfg.num_stages:
        raise ValueError(f"ServingEngine(mesh=): {sizes.get('pod')} pods "
                         f"but num_stages {cfg.num_stages}; stage s runs "
                         f"on pod s")


@dataclasses.dataclass
class AgreedMonitor(HeartbeatMonitor):
    """The heartbeat sweep of a rank engine: rank ``src``'s verdict on
    which domains went stale, on every rank of ``group``."""

    group: Any = None
    src: int = 0

    def sweep(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.monotonic()
        doms = list(self.rm.domains())
        stale = RK.share([d.healthy and now - d.last_heartbeat
                          > self.timeout_s for d in doms],
                         self.src, self.group)
        dead = []
        for d, x in zip(doms, stale):
            if x:
                self.rm.mark_unhealthy(d.name)
                dead.append(d.name)
        return dead


@dataclasses.dataclass
class _Layout:
    """What a rank keeps of one stage layout: its decoder (whose boundary
    counters a graph reads) and its managed functions, one per piece of
    device work between two messages."""

    dec: PipelinedDecoder
    segs: Dict[str, Any]            # the decode step's (rank_segments)
    probe: Any
    events: Any
    prefill: Dict[str, Any]         # kind -> its crossing_segment
    io: Tuple[Any, ...] = ()        # (gather, scatter) on the paged layout


class _RankEntry:
    """A prefill entry point of a rank engine, called and warmed as the
    one-card engine calls and warms its managed prefill: ``kind``'s
    managed ``crossing_segment`` of the current layout, between this
    rank's messages (``_Ranked._forward``, ``_warm_forward``)."""

    def __init__(self, be: "_Ranked", kind: str):
        self.be, self.kind = be, kind

    def __call__(self, *inputs):
        return self.be._forward(self.kind, inputs)

    def warm(self, *inputs) -> None:
        self.be._warm_forward(self.kind, inputs)


class _Eager:
    """A rank engine's function over a model axis, run eagerly and
    unmanaged: its layers message the model group (a CUDA graph cannot
    hold a collective), so nothing is captured and ``warm`` runs
    nothing."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def warm(self, *args) -> None:
        """Nothing to capture."""


# prefill kinds: (the model API's function, its batch's length key)
_PREFILL = {"prefill_at": ("prefill_at_fn", "prompt_len"),
            "prefill_packed": ("prefill_packed_fn", "prompt_lens")}


class _Ranked:
    """A pipelined backend's half on a rank (see the module docstring).

    Each stage layout keeps its decoder and its managed functions
    (``_Layout``), as ``_Pipelined`` does on one card, so a swap back, or
    onto a layout the warmup toured, finds its graphs. They read the
    rank's params and KV from slabs sized for the most layers this rank's
    stage takes over the planned layout and the warmup's tour: a layout
    uses a leading view of them, and a swap writes its layers into them in
    place, so a graph's addresses stay valid across swaps. A layout beyond
    the slabs reallocates them and drops every graph of the rank."""

    def _rank_setup(self, mesh, host_params, key: int,
                    layouts: Sequence[Tuple[int, ...]]) -> None:
        self.mesh, self.host_params, self.key = mesh, host_params, key
        self.slab_layouts = tuple(tuple(x) for x in layouts)
        self.staging = RK.Staging()
        self.dec: Optional[PipelinedDecoder] = None
        self._kv_slab = self._param_slab = None
        self.capacity = 0               # layers the slabs hold
        self.reallocations = 0
        # the per-token prefill's private caches, by (layout, width)
        self.token_caches: Dict[Tuple, Dict[str, Any]] = {}
        self._crossing_seq = 0          # crossing sequence numbers taken
        self._restage_seq = 0
        self._exchange_n = 0            # KV exchanges taken (data ranks)
        # (host ms, bytes this rank sent) of each prefill crossing this
        # rank sent, of each restage and of each decode step's KV
        # exchange, the latest LOG_CAP
        self.crossings: Deque[Tuple[float, int]] = deque(maxlen=LOG_CAP)
        self.restages: Deque[Tuple[float, int]] = deque(maxlen=LOG_CAP)
        self.exchanges: Deque[Tuple[float, int]] = deque(maxlen=LOG_CAP)
        # (segment ms, message ms) of each decode step (``rank_loop``)
        self.step_splits: Deque[Tuple[float, float]] = deque(
            maxlen=LOG_CAP)
        self.relayouts = 0      # swap-ins whose columns moved first
        # the horizon whose block of positions the timeline holds here (0:
        # whole), and the KV heads of a swap row its pools hold (``_alloc``)
        self.positions = 0
        self._heads: Optional[slice] = None

    @property
    def stage(self) -> int:
        return self.dec.stage

    @property
    def data(self) -> int:
        return self.dec.data

    def share_first(self, values: Sequence[float]) -> List[float]:
        """Global rank 0's ``values`` on every rank of the world."""
        return RK.share(values, 0, None)

    def verdicts(self, ok: bool) -> List[bool]:
        """Every rank's verdict, in global rank order, on every rank."""
        got = RK.all_gather(self.staging, torch.tensor(
            [int(bool(ok))], device=RK.message_device(None)), None,
            tag="verdict")
        return [bool(v) for v in got.reshape(-1).tolist()]

    # -- slabs ---------------------------------------------------------------
    def _alloc(self, dec: PipelinedDecoder) -> None:
        """The slabs at construction, for the most layers this rank's stage
        takes over ``slab_layouts``: the params' (its first layers loaded)
        and the KV's (zeros, from the whole cache the backend made), each
        of this rank's blocks over a model axis (``dec.model_block``,
        ``dec.kv_block``: its KV heads where they divide, and on the
        timeline its block of the positions where they do not and the
        horizon does, ``positions``)."""
        seg = self.api.model.served_segment.name
        self.positions = 0 if self.paged else dec.positions_split(
            self.cfg.max_seq)
        self._heads = self._own_heads(dec)
        self.capacity = max(x[dec.stage] for x in self.slab_layouts)
        self._fixed_params = dec.stage_params(
            {k: v for k, v in self.host_params.items() if k != seg},
            self.device)
        self._param_slab = self._slab_like(map_tree(
            lambda t: t[0], dec.model_block(seg, self.host_params[seg])),
            self.capacity)
        self._kv_slab = self._slab_like(map_tree(
            lambda t: t[0], self._kv_of(dec, self.cache[seg])),
            self.capacity)
        self.cache[seg] = None          # the whole cache, freed
        if not self.paged:
            self._probe_body = map_tree(lambda t: t.clone(), self._kv_of(
                dec, self._probe_body))
        self._copy_params(dec)

    def _kv_of(self, dec: PipelinedDecoder, tree):
        """This rank's block of a cache tree whole over model."""
        return dec.kv_block(tree, self.paged, self.positions)

    def _own_heads(self, dec: PipelinedDecoder) -> slice:
        """The KV heads of the whole swap row this rank's pools hold:
        its block where they divide over the model axis, else all."""
        kvh = self.api.cfg.num_kv_heads
        m = dec.num_model
        if m == 1 or kvh % m:
            return slice(0, kvh)
        n = kvh // m
        return slice(dec.model * n, (dec.model + 1) * n)

    def _copy_params(self, dec: PipelinedDecoder) -> None:
        """``dec``'s layers of this rank (its blocks over a model axis),
        from the host tree into the params slab."""
        lo, hi = dec.ranges[dec.stage]
        seg = self.api.model.served_segment.name
        for slab, h in zip(leaves(self._param_slab), leaves(dec.model_block(
                seg, map_tree(lambda t: t[lo:hi], self.host_params[seg])))):
            slab[:hi - lo].copy_(h)

    def _slab_like(self, layer, n: int):
        return map_tree(lambda t: torch.zeros((n,) + tuple(t.shape),
                                              dtype=t.dtype,
                                              device=self.device), layer)

    def _views(self) -> None:
        """``params`` and the cache's served segment as this layout's
        leading views of the slabs."""
        n = self.dec.stage_counts[self.stage]
        seg = self.api.model.served_segment.name
        self.params = dict(self._fixed_params,
                           **{seg: map_tree(lambda t: t[:n],
                                            self._param_slab)})
        self.cache[seg] = map_tree(lambda t: t[:n], self._kv_slab)

    def _load(self, kv) -> None:
        """This layout's layers into the slabs, in place: the params from
        the host tree, the KV from ``kv`` (its layers over the new range, a
        temporary). A layout beyond the slabs first reallocates them, and
        then every graph of the rank is dropped: each is entered again as
        a stall."""
        n = self.dec.stage_counts[self.stage]
        if n > self.capacity:
            self.capacity = n
            self._param_slab = self._slab_like(
                map_tree(lambda t: t[0], self._param_slab), n)
            self._kv_slab = self._slab_like(
                map_tree(lambda t: t[0], self._kv_slab), n)
            self.aot.drop_graphs()
            self._probe_aot.drop_graphs()
            self.reallocations += 1
        self._copy_params(self.dec)
        for slab, t in zip(leaves(self._kv_slab), leaves(kv)):
            slab[:n].copy_(t)
        self._views()

    def reset_state(self) -> None:
        """The backend's reset, every layer of the KV slab zeroed (a toured
        layout may have left entries past this layout's view) and the
        logs restarted. The sequence numbers keep running."""
        super().reset_state()
        if self._kv_slab is not None:
            for t in leaves(self._kv_slab):
                t.zero_()
        for log in (self.crossings, self.restages, self.exchanges,
                    self.step_splits):
            log.clear()
        self.relayouts = 0

    # -- layouts -------------------------------------------------------------
    def _build(self, stage_blocks: Sequence[int]) -> None:
        self.stage_blocks = key = tuple(stage_blocks)
        hit = self._layouts.get(key)
        if hit is None:
            hit = self._layouts[key] = self._new_layout(key)
        self.dec, self._probe, self._events = hit.dec, hit.probe, hit.events
        self._segs, self._prefill = hit.segs, hit.prefill
        if hit.io:
            self._gather, self._scatter = hit.io
        self._views()

    def _new_layout(self, key: Tuple[int, ...]) -> _Layout:
        cfg = self.cfg
        dec = PipelinedDecoder(self.api, num_stages=cfg.num_stages,
                               num_microbatches=cfg.num_microbatches,
                               seal_boundary=cfg.seal_boundary,
                               stage_blocks=key, mesh=self.mesh,
                               prefill_role=cfg.disagg_role == "prefill")
        dec.staging = self.staging
        if self._kv_slab is None:
            self._key_dev = self._idx([self.key])
            self._alloc(dec)
        # over a model axis every function messages the model group:
        # eager and unmanaged (warmup there is refused, check_rank_mesh)
        tp = dec.num_model > 1
        wrap = (lambda reg, name, f: _Eager(f)) if tp else \
            (lambda reg, name, f: reg.wrap(name, f))
        segs = {n: wrap(self.aot, f"{n}{key}", self._bound(f))
                for n, f in dec.rank_segments(paged=self.paged).items()}
        probe = dec.build_stage_probe(paged=self.paged)
        events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(2)) \
            if self.device.type == "cuda" else None

        def run_probe(s: int, arg: torch.Tensor) -> torch.Tensor:
            if events:
                events[0].record()
            x = torch.zeros((self._probe_rows, 1, self.api.cfg.d_model),
                            dtype=self.api.dtype, device=self.device)
            out = self._run_probe(probe, s, x, arg)
            if events:
                events[1].record()
            return out

        lo, hi = dec.ranges[dec.stage]
        kinds = ("prefill_at", "prefill_packed", "prefill_token") + (
            ("prefill_chunk",) if self.paged else ())
        prefill = {kind: wrap(self.aot, f"{kind}{key}", dec.crossing_segment(
            self._prefill_run(kind, lo, hi))) for kind in kinds}
        # a data rank other than 0 gathers empty parts: nothing to capture
        io = (wrap(self.aot, f"gather_pages{key}", self._gather_fn)
              if dec.data == 0 else self._gather_fn,
              wrap(self.aot, f"scatter_pages{key}", self._scatter_fn)) \
            if self.paged else ()
        return _Layout(dec, segs, wrap(self._probe_aot, f"probe{key}",
                                       run_probe), events, prefill, io)

    def _bound(self, f):
        """A decode segment over this rank's params and cache, read at the
        call (a capture holds the slabs' addresses)."""
        return lambda *args: f(self.params, self._step_cache(), *args)

    def _span(self) -> Tuple[int, int]:
        return self.dec.ranges[self.stage]

    def own_layers(self, tree):
        """This rank's layers of a timeline-shaped tree of stacked layer
        leaves (a private prefill cache), its block of them over a model
        axis (its positions too where the timeline splits them)."""
        return self.dec._cut(self.dec.kv_block(tree, False, self.positions))

    def step(self, tokens: np.ndarray, key) -> torch.Tensor:
        """One decode step: this layout's managed segments between the
        rank's messages (``PipelinedDecoder.rank_loop``), its boundaries
        sealed under ``key`` and its KV exchange under the rank's key and
        the next exchange number."""
        toks = self._tokens(tokens)
        n = self._exchange_n
        self._exchange_n += 1
        exchange = (self._key_dev, self._idx(self.dec.exchange_counters(n))) \
            if self.dec.exchanges(toks.shape[0]) else None
        self.dec.last_exchange = None
        with self.dec.context(self.positions):
            logits = self.dec.rank_loop(self._segs, toks,
                                        self._key_tensor(key), exchange)
        if self.dec.last_exchange is not None:
            self.exchanges.append(self.dec.last_exchange)
        self.step_splits.append(self.dec.last_split)
        self.steps += 1
        return logits

    def swap(self, stage_blocks: Sequence[int]) -> bool:
        """Rebuild on the new boundaries (or take the layout kept), move the
        layers that change owner (``PipelinedDecoder.restage_cache``) and
        write the new layers into the slabs in place."""
        old = self.dec
        t0, sent0 = time.perf_counter(), self.staging.sent
        old_cache = self._step_cache()
        if isinstance(old_cache, dict):
            old_cache = dict(old_cache)     # _build re-views its segment
        self._build(stage_blocks)
        seq = self._restage_seq
        self._restage_seq += RESTAGE_SEQS
        self._load(self._restage(old, old_cache, seq))
        self._sync()
        self.restages.append(((time.perf_counter() - t0) * 1e3,
                              self.staging.sent - sent0))
        self.warm_probes()
        return True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_probes(self) -> None:
        """Warm this rank's own stage probe (state-neutral); a data rank
        other than 0 never probes."""
        if self.data == 0:
            self._probe.warm(self.stage, self._probe_arg())

    def stage_times(self) -> List[float]:
        """Seconds of each stage's layers on one microbatch, as on one
        card (``_Pipelined.stage_times``), each measured by data rank 0 of
        its pod (every model rank of it: the probe's layers message the
        model group; model rank 0's time is the stage's), one pod after
        another (pod s probes once s - 1's time has reached it: two
        probes never share a card), on every rank of the world."""
        arg = self._probe_arg()
        times = []
        for s, rank in enumerate(self.dec.stage_leads):
            t = 0.0
            if s == self.stage and self.data == 0:
                with self.dec.context(self.positions):
                    if self._events:
                        self._probe(s, arg)
                        start, end = self._events
                        end.synchronize()
                        t = start.elapsed_time(end) / 1e3
                    else:
                        t0 = time.perf_counter()
                        self._probe(s, arg)
                        t = time.perf_counter() - t0
            times += RK.share([t], rank, None)
        return times

    # -- admission: this rank's layers of a prefill ---------------------------
    def _prefill_run(self, kind: str, lo: int, hi: int):
        """``run(x, *inputs) -> (out, extra)`` of a prefill ``kind`` over
        layers [lo, hi) of this rank (``x`` the hidden state in, None on
        stage 0): the model API's functions with ``start=``, ``end=``.
        One-shot and packed prefill return this rank's layers of their KV
        as ``extra``; the per-token step takes the width of its private
        cache (``token_caches``), the chunk writes the live pools."""
        api, seg = self.api, self.api.model.served_segment.name

        def batch(x, **kw):
            return kw if x is None else dict(kw, hidden=x)

        if kind in _PREFILL:
            fn, lens = _PREFILL[kind]

            def run(x, toks, plens):
                out, caches = getattr(api, fn)(
                    self.params, batch(x, tokens=toks, **{lens: plens}),
                    start=lo, end=hi)
                return out, caches[seg]
        elif kind == "prefill_token":
            def run(x, tok, S: int):
                cache = self.token_caches[(self.stage_blocks, S)]
                return api.decode_fn(self.params, cache, batch(x, tokens=tok),
                                     start=lo, end=hi)[0], None
        else:
            def run(x, toks, offset, chunk_len, bt_row, pages, offs):
                return api.prefill_chunk_fn(
                    self.params, {seg: self.body},
                    batch(x, tokens=toks, offset=offset, chunk_len=chunk_len,
                          bt_row=bt_row, pages=pages, offs=offs),
                    start=lo, end=hi)[0], None
        return run

    def entry(self, kind: str) -> _RankEntry:
        """The engine's ``kind`` of prefill on this rank."""
        return _RankEntry(self, kind)

    @staticmethod
    def _frame(kind: str, inputs) -> Tuple[Tuple[int, ...], int]:
        """(the hidden state's leading shape, the logits' rows) of a
        prefill call."""
        if kind == "prefill_token":
            return (1, 1), 1
        shape = tuple(inputs[0].shape)
        return shape, (shape[0] if kind in _PREFILL else 1)

    def _crossing_ctr(self) -> torch.Tensor:
        """The next call's crossing counters on the device."""
        seq = self._crossing_seq
        self._crossing_seq += self.cfg.num_stages - 1
        return self._idx(self.dec.crossing_counters(seq))

    def _forward(self, kind: str, inputs):
        """One prefill call of ``kind`` (``PipelinedDecoder.rank_forward``)
        under the next crossing sequence numbers; the crossing this rank
        sends is kept in ``crossings``. Returns the logits on every rank,
        and one-shot and packed prefill this rank's layers of their KV."""
        shape, rows = self._frame(kind, inputs)
        self.dec.last_crossing = None
        with self.dec.context(self.positions):
            logits, extra = self.dec.rank_forward(
                self._prefill[kind], shape, rows, self._key_dev,
                self._crossing_ctr(), *inputs)
        if self.dec.last_crossing is not None:
            self.crossings.append(self.dec.last_crossing)
        return (logits, extra) if kind in _PREFILL else logits

    def _warm_forward(self, kind: str, inputs) -> None:
        """Warm ``kind``'s segment at ``inputs``' signature without a
        message: a stage that receives takes a payload of zeros. Its
        crossing counters are drawn like a real call's, so no pair a warm
        run seals under is used again."""
        shape, _ = self._frame(kind, inputs)
        got = None
        if self.stage > 0:
            got = torch.zeros((math.prod(shape), self.api.cfg.d_model),
                              device=self.device, dtype=(
                                  int_dtype_of(self.api.dtype)
                                  if self.cfg.seal_boundary
                                  else self.api.dtype))
        self._prefill[kind].warm(shape, got, self._key_dev,
                                 self._crossing_ctr(), *inputs)

    def warm_insert(self, cache) -> None:
        """Warm the slot insert of this layout (the timeline's; the paged
        layout has none)."""


class RankPagedBackend(_Ranked, PagedPipelinedBackend):
    """``PagedPipelinedBackend`` on a rank: the pools hold this rank's
    layers ``[L_s, N, KVH, Pg, D]`` (a view of its slab); block tables and
    seq_lens are whole, as the reference replicates them."""

    def __init__(self, api, host_params, cfg, num_pages: int,
                 pages_per_slot: int, stage_blocks, aot, mesh, key: int,
                 layouts):
        self._rank_setup(mesh, host_params, key, layouts)
        super().__init__(api, None, cfg, num_pages, pages_per_slot,
                         stage_blocks, aot=aot)
        self._chunk = self.entry("prefill_chunk")

    def _restage(self, old_dec: PipelinedDecoder, old_cache, seq: int):
        seg = self.api.model.served_segment.name
        return old_dec.restage_cache(old_cache, self.dec, key=self.key,
                                     seq=seq)[seg]

    # -- the sealed swap over this rank's window of the rows ------------------
    def _per_layer(self, pool: torch.Tensor) -> int:
        """Columns of one layer of a swap row: every KV head of a page,
        whatever this rank's pools hold of them."""
        return self.api.cfg.num_kv_heads * math.prod(pool.shape[3:])

    def _window(self, pool: torch.Tensor, span=None) -> Tuple[int, int]:
        """(col0, row_cols) of this rank's layers in a swap row."""
        per = self._per_layer(pool)
        lo, _ = span or self._span()
        return lo * per, self.api.model.served_segment.n * per

    def swap_layout(self):
        return self.dec.ranges

    def cipher_window(self, layout) -> Tuple[int, int]:
        return self._window(self.body[0], layout[self.stage])

    def _gather_fn(self, pg: torch.Tensor, key: torch.Tensor,
                   seq: torch.Tensor):
        empty = tuple(torch.empty((pg.shape[0], 0), device=pool.device,
                                  dtype=int_dtype_of(pool.dtype))
                      for pool in self.body)
        if self.data > 0:
            # data rank 0 of the pod seals the pod's part; the others keep
            # an empty one, so that every (key, counter) is sealed once
            return empty
        pages = self._heads_to_lead([pool[:, pg] for pool in self.body])
        if pages is None:
            return empty
        out = []
        for part, (pool, got) in enumerate(zip(self.body, pages)):
            rows = got.transpose(0, 1).reshape(pg.shape[0], -1)
            col0, row_cols = self._window(pool)
            out.append(sealing.seal_pages(rows, key, seq, part=part,
                                          col0=col0, row_cols=row_cols))
        return tuple(out)

    def _heads_to_lead(self, parts):
        """Swapped pages [L_s, n, KVH_m, Pg, D] of this rank's KV heads ->
        every KV head of them on model rank 0 (the model ranks' blocks
        sent to it, side by side in model order; the pages themselves
        where the pools hold every KV head), None on the other model
        ranks, which seal nothing."""
        dec = self.dec
        if dec.num_model == 1:
            return parts
        if self._heads == slice(0, self.api.cfg.num_kv_heads):
            return parts if dec.lead else None
        group = dec._model_group
        ranks = RK.group_ranks(group)
        if not dec.lead:
            RK.transfer(self.staging, [(ranks[0], list(parts))], [],
                        group, tag="heads")
            return None
        got = RK.transfer(self.staging, [], [
            (r, [torch.empty_like(p) for p in parts]) for r in ranks[1:]],
            group, tag="heads")
        return [torch.cat([p] + [g[i] for g in got], dim=2)
                for i, p in enumerate(parts)]

    def _scatter_fn(self, ck: torch.Tensor, cv: torch.Tensor,
                    pages: torch.Tensor, key: torch.Tensor,
                    seq: torch.Tensor) -> None:
        keep = pages < self.num_pages
        target = torch.where(keep, pages, torch.zeros_like(pages))
        for part, (pool, c) in enumerate(zip(self.body, (ck, cv))):
            col0, row_cols = self._window(pool)
            rows = sealing.unseal_pages(c, key, seq, pool.dtype, part=part,
                                        col0=col0, row_cols=row_cols)
            # every KV head of the window, this rank's kept
            g = rows.reshape(pages.shape[0], pool.shape[0],
                             self.api.cfg.num_kv_heads,
                             *pool.shape[3:])[:, :, self._heads]
            g = torch.where(keep.view(-1, *[1] * (g.dim() - 1)), g,
                            torch.zeros_like(g))
            pool[:, target] = g.transpose(0, 1)

    def scatter_pages(self, ck, cv, pages, key, ctr, layout=None) -> None:
        """``PagedLocalBackend.scatter_pages`` of this rank's part of a
        payload sealed under the stage ``layout`` (its layer ranges): if a
        live re-plan moved layers since, their cipher columns first go to
        their new owners (``_relayout``)."""
        if layout is not None and tuple(layout) != self.dec.ranges:
            if self.data == 0 and self.dec.lead:
                ck, cv = self._relayout((ck, cv), tuple(layout))
            self.relayouts += 1
        if self.dec.num_data > 1 or self.dec.num_model > 1:
            ck, cv = self._share_part((ck, cv))
        super().scatter_pages(ck, cv, pages, key, ctr)

    def _share_part(self, parts):
        """The part of a payload that data rank 0 (model rank 0) of the
        pod holds (cipher text, its columns under the current layout) on
        every (data, model) rank of its pod: it sends it, the others
        receive it in place of their empty parts; each then unseals it
        under the same (key, counter) and keeps its KV heads."""
        group = self.dec._local_group
        ranks = RK.group_ranks(group)
        if self.data == 0 and self.dec.lead:
            RK.transfer(self.staging, [(r, list(parts)) for r in ranks[1:]],
                        [], group, tag="part")
            return parts
        lo, hi = self._span()
        likes = [torch.empty((p.shape[0], (hi - lo) * self._per_layer(pool)),
                             dtype=p.dtype, device=p.device)
                 for p, pool in zip(parts, self.body)]
        return tuple(RK.transfer(self.staging, [], [(ranks[0], likes)],
                                 group, tag="part")[0])

    def _relayout(self, parts, old: Tuple[Tuple[int, int], ...]):
        """This rank's payload parts (cipher [rows, layers x per]) sealed
        under layer ranges ``old`` -> its parts under the current ranges:
        each rank sends the columns of the layers it held to their new
        owners. Cipher text only crosses; the (key, counter) and the
        columns' keystream indices are the one-device payload's."""
        s, new = self.stage, self.dec.ranges
        (olo, _), (nlo, nhi) = old[s], new[s]
        per = [p.shape[1] // (old[s][1] - olo) for p in parts]
        outgoing, incoming, moves = [], [], []
        for a, (alo, ahi) in enumerate(old):
            for b, (blo, bhi) in enumerate(new):
                lo, hi = max(alo, blo), min(ahi, bhi)
                if a == b or lo >= hi:
                    continue
                if a == s:
                    outgoing.append((self.dec._pod_ranks[b], [
                        p[:, (lo - olo) * w:(hi - olo) * w].contiguous()
                        for p, w in zip(parts, per)]))
                elif b == s:
                    incoming.append((self.dec._pod_ranks[a], [
                        torch.empty((p.shape[0], (hi - lo) * w),
                                    dtype=p.dtype, device=p.device)
                        for p, w in zip(parts, per)]))
                    moves.append(lo)
        got = RK.transfer(self.staging, outgoing, incoming,
                          self.dec._pod_group, tag="relayout")
        pieces = dict(zip(moves, got))
        lo, hi = max(olo, nlo), min(old[s][1], nhi)
        if lo < hi:
            pieces[lo] = [p[:, (lo - olo) * w:(hi - olo) * w]
                          for p, w in zip(parts, per)]
        return tuple(torch.cat([pieces[k][i] for k in sorted(pieces)], 1)
                     for i in range(len(parts)))


class RankTimelineBackend(_Ranked, PipelinedDecodeBackend):
    """``PipelinedDecodeBackend`` on a rank: the timeline body holds this
    rank's layers (a view of its slab); ``len`` and ``start`` are
    whole."""

    def __init__(self, api, host_params, cfg, stage_blocks, aot, mesh,
                 key: int, layouts):
        self._rank_setup(mesh, host_params, key, layouts)
        super().__init__(api, None, cfg, stage_blocks, aot=aot)

    def _restage(self, old_dec: PipelinedDecoder, old_cache, seq: int):
        return old_dec.restage_cache(old_cache, self.dec, key=self.key,
                                     seq=seq)[0]

    def warm_insert(self, cache) -> None:
        self._insert.warm(cache[self.api.model.served_segment.name],
                          cache["start"], self._idx([0]))


def host_copy(params):
    """The whole params tree on the host: ``params`` itself when every leaf
    is there already (so two engines built over one host tree share it),
    else a copy."""
    if all(t.device.type == "cpu" and not t.requires_grad
           for t in leaves(params)):
        return params
    return map_tree(lambda t: t.detach().to("cpu"), params)

