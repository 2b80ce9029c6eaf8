"""The serving engine's pipelined backends with one stage per pod of
ranks.

``ServingEngine(api, config, params, mesh=mesh, backend="pipelined")``,
called on every rank of a pod x data mesh of ranks (``launch.ranks.spawn``,
then ``launch.mesh.make_mesh((S, D), ("pod", "data"))``), serves with
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

Refused by name (ROADMAP item 10d): a ``model`` axis above 1, CUDA-graph
warmup (a step that messages between its kernels) and the disaggregated
pair. The stage probes keep their graphs: they send nothing.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Deque, List, Optional, Sequence, Tuple

import torch

from repro_torch.enclave import sealing
from repro_torch.kernels.seal import int_dtype_of
from repro_torch.launch import ranks as RK
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.runtime.pipeline import RESTAGE_SEQS, PipelinedDecoder
from repro_torch.serving.engine import (PagedPipelinedBackend,
                                        PipelinedDecodeBackend)
from repro_torch.tree import map_tree

LOG_CAP = 4096          # crossings and restages a backend remembers


def check_rank_mesh(mesh, cfg, backend: str) -> None:
    """What a rank engine serves, refused by name otherwise."""
    from repro_torch.sharding import rules as R
    if cfg.warmup:
        raise NotImplementedError(
            "ServingEngine(mesh=) with warmup=True: CUDA-graph capture of "
            "a decode step that messages between ranks between its kernels "
            "(ROADMAP item 10d)")
    if cfg.disagg_role:
        raise NotImplementedError(
            f"ServingEngine(mesh=) with disagg_role={cfg.disagg_role!r}: "
            f"the disaggregated pair over ranks (ROADMAP item 10d)")
    sizes = R.mesh_axis_sizes(mesh)
    if not R.is_device_mesh(mesh):
        raise ValueError(f"ServingEngine(mesh=): a DeviceMesh of ranks "
                         f"(launch.ranks.spawn, then make_mesh), got "
                         f"{sizes}")
    if backend != "pipelined":
        raise ValueError(f"ServingEngine(mesh=) serves one stage a rank on "
                         f"the pipelined backend, not backend={backend!r}")
    wide = {a: k for a, k in sizes.items()
            if a not in ("pod", "data") and k > 1}
    if wide:
        raise NotImplementedError(
            f"ServingEngine(mesh=): mesh axes {wide}: the engine's ranks "
            f"run over pod and data only; tensor parallelism is ROADMAP "
            f"item 10d")
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


class _Ranked:
    """A pipelined backend's half on a rank (see the module docstring):
    this rank's stage of each layout, built from the host params anew at
    every swap (the device state a layout's step and probe were built
    over moves with a restage, so nothing is kept per layout)."""

    def _rank_setup(self, mesh, host_params, key: int) -> None:
        self.mesh, self.host_params, self.key = mesh, host_params, key
        self.staging = RK.Staging()
        self.dec: Optional[PipelinedDecoder] = None
        self._crossing_seq = 0          # crossing sequence numbers taken
        self._restage_seq = 0
        self._exchange_n = 0            # KV exchanges taken (data ranks)
        # (host ms, bytes this rank sent) of each prefill crossing this
        # rank sent, of each restage and of each decode step's KV
        # exchange, the latest LOG_CAP
        self.crossings: Deque[Tuple[float, int]] = deque(maxlen=LOG_CAP)
        self.restages: Deque[Tuple[float, int]] = deque(maxlen=LOG_CAP)
        self.exchanges: Deque[Tuple[float, int]] = deque(maxlen=LOG_CAP)
        self.relayouts = 0      # swap-ins whose columns moved first

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

    def _build(self, stage_blocks: Sequence[int]) -> None:
        cfg = self.cfg
        self.stage_blocks = key = tuple(stage_blocks)
        first = self.dec is None
        dec = PipelinedDecoder(self.api, num_stages=cfg.num_stages,
                               num_microbatches=cfg.num_microbatches,
                               seal_boundary=cfg.seal_boundary,
                               stage_blocks=key, mesh=self.mesh)
        dec.staging = self.staging
        self.params = None              # the old layout's, freed first
        self.params = dec.stage_params(self.host_params, self.device)
        step_fn = dec.build(paged=self.paged)
        probe = dec.build_stage_probe(paged=self.paged)

        def step(toks, step_key):
            dec.last_exchange = None
            n = self._exchange_n
            self._exchange_n += 1
            out = step_fn(self.params, self._step_cache(),
                          {"tokens": toks, "exchange": (self.key, n)},
                          step_key)[0]
            if dec.last_exchange is not None:
                self.exchanges.append(dec.last_exchange)
            return out

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

        self.dec, self._events = dec, events
        self._step = self.aot.wrap(f"step{key}", step)
        self._probe = self._probe_aot.wrap(f"probe{key}", run_probe)
        if first:
            self._own_cache(dec)

    def _own_cache(self, dec: PipelinedDecoder) -> None:
        """Cut the freshly made whole cache to this rank's layers."""
        seg = self.api.model.served_segment.name
        self.cache[seg] = dec._cut(self.cache[seg])

    def own_layers(self, tree):
        """This rank's layers of a tree of stacked layer leaves (a private
        prefill cache)."""
        return self.dec._cut(tree)

    def swap(self, stage_blocks: Sequence[int]) -> bool:
        """Rebuild on the new boundaries and move the layers that change
        owner (``PipelinedDecoder.restage_cache``)."""
        old = self.dec
        t0, sent0 = time.perf_counter(), self.staging.sent
        self._build(stage_blocks)
        seq = self._restage_seq
        self._restage_seq += RESTAGE_SEQS
        self._restage(old, seq)
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
        its pod, one pod after another (pod s probes once s - 1's time
        has reached it: two probes never share a card), on every rank of
        the world."""
        arg = self._probe_arg()
        times = []
        for s, rank in enumerate(self.dec.stage_leads):
            t = 0.0
            if s == self.stage and self.data == 0:
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
    def _forward(self, run, shape: Tuple[int, ...], rows: int
                 ) -> torch.Tensor:
        """``PipelinedDecoder.rank_forward`` under the next crossing
        sequence numbers; the crossing this rank sends is kept in
        ``crossings``."""
        seq = self._crossing_seq
        self._crossing_seq += self.cfg.num_stages - 1
        self.dec.last_crossing = None
        logits = self.dec.rank_forward(run, shape, rows, self.key, seq)
        if self.dec.last_crossing is not None:
            self.crossings.append(self.dec.last_crossing)
        return logits

    def _span(self) -> Tuple[int, int]:
        return self.dec.ranges[self.stage]

    def prefill(self, fn, toks: torch.Tensor, batch) -> Tuple[Any, Any]:
        """One one-shot or packed prefill (``fn``: the model API's
        ``prefill_at_fn`` or ``prefill_packed_fn``) of ``toks`` [B, S_pad]:
        (the logits on every rank, this rank's layers of its KV)."""
        lo, hi = self._span()
        kv = []

        def run(x):
            b = dict(batch, tokens=toks)
            if x is not None:
                b["hidden"] = x
            out, caches = fn(self.params, b, start=lo, end=hi)
            kv.append(caches[self.api.model.served_segment.name])
            return out

        return self._forward(run, tuple(toks.shape), toks.shape[0]), kv[0]

    def prefill_token(self, tok: torch.Tensor, cache) -> torch.Tensor:
        """One [1, 1] step of per-token prefill over this rank's layers of
        the private cache ``cache``."""
        lo, hi = self._span()

        def run(x):
            b = {"tokens": tok}
            if x is not None:
                b["hidden"] = x
            return self.api.decode_fn(self.params, cache, b, start=lo,
                                      end=hi)[0]

        return self._forward(run, (1, 1), 1)


class RankPagedBackend(_Ranked, PagedPipelinedBackend):
    """``PagedPipelinedBackend`` on a rank: the pools hold this rank's
    layers ``[L_s, N, KVH, Pg, D]``; block tables and seq_lens are whole,
    as the reference replicates them."""

    def __init__(self, api, host_params, cfg, num_pages: int,
                 pages_per_slot: int, stage_blocks, aot, mesh, key: int):
        self._rank_setup(mesh, host_params, key)
        super().__init__(api, None, cfg, num_pages, pages_per_slot,
                         stage_blocks, aot=aot)

    def _restage(self, old_dec: PipelinedDecoder, seq: int) -> None:
        self.cache = old_dec.restage_cache(self.cache, self.dec,
                                           key=self.key, seq=seq)

    def _prefill_chunk(self, toks, offset: int, chunk_len, bt_row, pages,
                       offs) -> torch.Tensor:
        lo, hi = self._span()
        seg = self.api.model.served_segment.name

        def run(x):
            b = {"tokens": toks, "offset": offset, "chunk_len": chunk_len,
                 "bt_row": bt_row, "pages": pages, "offs": offs}
            if x is not None:
                b["hidden"] = x
            return self.api.prefill_chunk_fn(self.params, {seg: self.body},
                                             b, start=lo, end=hi)[0]

        return self._forward(run, tuple(toks.shape), 1)

    # -- the sealed swap over this rank's window of the rows ------------------
    def _window(self, pool: torch.Tensor, span=None) -> Tuple[int, int]:
        """(col0, row_cols) of this rank's layers in a swap row."""
        per = math.prod(pool.shape[2:])
        lo, _ = span or self._span()
        return lo * per, self.api.model.served_segment.n * per

    def swap_layout(self):
        return self.dec.ranges

    def cipher_window(self, layout) -> Tuple[int, int]:
        return self._window(self.body[0], layout[self.stage])

    def _gather_fn(self, pg: torch.Tensor, key: torch.Tensor,
                   seq: torch.Tensor):
        if self.data > 0:
            # data rank 0 of the pod seals the pod's part; the others keep
            # an empty one, so that every (key, counter) is sealed once
            return tuple(torch.empty((pg.shape[0], 0), device=pool.device,
                                     dtype=int_dtype_of(pool.dtype))
                         for pool in self.body)
        out = []
        for part, pool in enumerate(self.body):
            rows = pool[:, pg].transpose(0, 1).reshape(pg.shape[0], -1)
            col0, row_cols = self._window(pool)
            out.append(sealing.seal_pages(rows, key, seq, part=part,
                                          col0=col0, row_cols=row_cols))
        return tuple(out)

    def _scatter_fn(self, ck: torch.Tensor, cv: torch.Tensor,
                    pages: torch.Tensor, key: torch.Tensor,
                    seq: torch.Tensor) -> None:
        keep = pages < self.num_pages
        target = torch.where(keep, pages, torch.zeros_like(pages))
        for part, (pool, c) in enumerate(zip(self.body, (ck, cv))):
            col0, row_cols = self._window(pool)
            rows = sealing.unseal_pages(c, key, seq, pool.dtype, part=part,
                                        col0=col0, row_cols=row_cols)
            g = rows.reshape(pages.shape[0], pool.shape[0], *pool.shape[2:])
            g = torch.where(keep.view(-1, *[1] * (g.dim() - 1)), g,
                            torch.zeros_like(g))
            pool[:, target] = g.transpose(0, 1)

    def scatter_pages(self, ck, cv, pages, key, ctr, layout=None) -> None:
        """``PagedLocalBackend.scatter_pages`` of this rank's part of a
        payload sealed under the stage ``layout`` (its layer ranges): if a
        live re-plan moved layers since, their cipher columns first go to
        their new owners (``_relayout``)."""
        if layout is not None and tuple(layout) != self.dec.ranges:
            if self.data == 0:
                ck, cv = self._relayout((ck, cv), tuple(layout))
            self.relayouts += 1
        if self.dec.num_data > 1:
            ck, cv = self._share_part((ck, cv))
        super().scatter_pages(ck, cv, pages, key, ctr)

    def _share_part(self, parts):
        """Data rank 0's part of a payload (cipher text, its columns under
        the current layout) on every data rank of its pod: rank 0 sends
        it, the others receive it in place of their empty parts; each then
        unseals it under the same (key, counter)."""
        ranks = self.dec._data_ranks
        if self.data == 0:
            RK.transfer(self.staging, [(r, list(parts)) for r in ranks[1:]],
                        [], self.dec._data_group, tag="part")
            return parts
        lo, hi = self._span()
        likes = [torch.empty((p.shape[0], (hi - lo) * math.prod(
            pool.shape[2:])), dtype=p.dtype, device=p.device)
            for p, pool in zip(parts, self.body)]
        return tuple(RK.transfer(self.staging, [], [(ranks[0], likes)],
                                 self.dec._data_group, tag="part")[0])

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
    rank's layers; ``len`` and ``start`` are whole."""

    def __init__(self, api, host_params, cfg, stage_blocks, aot, mesh,
                 key: int):
        self._rank_setup(mesh, host_params, key)
        super().__init__(api, None, cfg, stage_blocks, aot=aot)

    def _restage(self, old_dec: PipelinedDecoder, seq: int) -> None:
        body, n, start = old_dec.restage_cache(self._step_cache(), self.dec,
                                               key=self.key, seq=seq)
        self.cache.update({self.api.model.served_segment.name: body,
                           "len": n, "start": start})


def host_copy(params):
    """The whole params tree on the host (the tensors themselves when they
    are there already)."""
    return map_tree(lambda t: t.detach().to("cpu"), params)

