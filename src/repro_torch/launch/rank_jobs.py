"""Rank bodies for ``launch.ranks.spawn``: the pipelined decoder, the
serving engine with one stage per pod (its data ranks splitting each
microbatch's rows) and the disaggregated pair on the same mesh, the
prefill and decode serve steps and the train step (plain or compressed)
over a mesh of pod, data and model ranks, each driven for a few steps
from inputs the caller hands over on the CPU, or from seeded weights
drawn on the rank's device.

    outs = spawn(rank_jobs.decode, 4, backend="gloo", device="cpu",
                 args=(DecodeJob(cfg, ((2, 2), ("pod", "data")), ...),))
    outs = spawn(rank_jobs.serve, 2, backend="gloo", device="cpu",
                 args=(ServeJob(cfg, [ServeRun(EngineConfig(...),
                                               requests)]),))
    outs = spawn(rank_jobs.disagg, 4, backend="gloo", device="cpu",
                 args=(DisaggJob(cfg, [DisaggRun(EngineConfig(...),
                                                 requests)], data=2),))

Each body returns, per rank, what it computed (logits, tokens, losses,
the rank's cache or params), the kernel launches it made (``ops.LAUNCHES``
over the driven steps only), host milliseconds a step and the bytes it
messaged, so a caller can hold the ranks against one device and against
each other.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import RankContext, Staging
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import (compressed_psum_pod,
                                           init_error_feedback)
from repro_torch.runtime import steps as S
from repro_torch.runtime.pipeline import PipelinedDecoder, axes_leaves
from repro_torch.serving import aot
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.sharding import fsdp as FS
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.tree import leaves, map_tree

Mesh = Tuple[Tuple[int, ...], Tuple[str, ...]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _model(ctx: RankContext, cfg, dtype, params, seed: int, max_seq: int):
    api = build_model(cfg, device=ctx.device, dtype=dtype, max_seq=max_seq)
    if params is None:
        params = api.init(torch.Generator(device=ctx.device).manual_seed(seed))
    else:
        params = map_tree(lambda t: t.to(ctx.device, copy=True), params)
    return api, params


def param_digest(tree) -> List[int]:
    """One int64 a leaf: the sum of its elements' bit patterns, each times
    an odd weight of its position, wrapping. Two trees whose digests agree
    leaf for leaf hold the same bits but with a vanishing chance: a single
    differing element always shows (an odd weight is invertible mod 2^64)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in leaves(tree):
        flat = t.detach().reshape(-1).view(ints[t.element_size()])
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        for lo in range(0, flat.numel(), 1 << 24):
            part = flat[lo:lo + (1 << 24)].to(torch.int64)
            w = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                             device=t.device).mul_(2).add_(1)
            total += (part * w).sum()
        out.append(int(total))
    return out


# ---------------------------------------------------------------------------
# The pipelined decoder over ranks
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeJob:
    """Greedy decode steps of ``PipelinedDecoder(mesh=)`` from one state.
    ``cache`` is a paged cache dict (pools, ``block_tables``,
    ``seq_lens``) or a timeline cache dict (the served segment's body and
    ``len``), on the CPU; ``tokens`` [B, 1] feed the first step, each
    later step the argmax of the last. Step i seals under ``key + i``.
    Each of ``layouts`` (stage block counts, None for even stages) runs
    with each of ``seals``, in that order; or, with ``spec``, the decoder
    is ``PipelinedDecoder.from_spec(spec)`` with each of ``seals``.
    ``params`` on the CPU, or None to draw them from ``seed`` on the
    rank's device (every rank draws the same bits)."""

    cfg: ArchConfig
    mesh: Mesh
    cache: Any
    tokens: torch.Tensor
    layouts: Sequence[Optional[Tuple[int, ...]]] = (None,)
    seals: Sequence[bool] = (True,)
    spec: Any = None
    num_microbatches: int = 2
    steps: int = 1
    key: int = 0xC0FFEE
    dtype: torch.dtype = torch.float32
    params: Any = None
    seed: int = 0
    max_seq: int = 4096
    ping_iters: int = 0


def decode(ctx: RankContext, job: DecodeJob) -> List[dict]:
    """One result a (layout, seal) run: ``logits`` and ``tokens`` a
    step, the rank's cache after the steps (its stage's layers), its
    stage, data index and layer range, ``launches``, ``host_ms`` a step
    and the bytes it sent a step. With ``ping_iters`` and two pods, one
    more entry: ``boundary``, the host time of one sealed microbatch's
    crossing between the two pods' ranks of one data index (a card's
    payload staged through the host under gloo), from that many round
    trips (``_ping``)."""
    api, params = _model(ctx, job.cfg, job.dtype, job.params, job.seed,
                         job.max_seq)
    mesh = make_mesh(*job.mesh, device=ctx.device)
    pods = dict(zip(job.mesh[1], job.mesh[0]))["pod"]
    paged = "block_tables" in job.cache
    out = []
    runs = [(blocks, seal) for blocks in
            ((None,) if job.spec is not None else job.layouts)
            for seal in job.seals]
    for blocks, seal in runs:
        if job.spec is not None:
            dec = PipelinedDecoder.from_spec(api, job.spec,
                                             job.num_microbatches,
                                             mesh=mesh, seal_boundary=seal)
        else:
            dec = PipelinedDecoder(api, num_stages=pods,
                                   num_microbatches=job.num_microbatches,
                                   seal_boundary=seal, stage_blocks=blocks,
                                   mesh=mesh)
        mine = dec.stage_params(params)
        cache = map_tree(lambda t: t.to(ctx.device, copy=True), job.cache)
        if paged:
            cache = dec.stage_paged_cache(cache)
            step = dec.build(paged=True)
        else:
            cache = dec.stage_cache(cache)
            step = dec.build(paged=False, per_slot_start=False)
        tok = job.tokens.to(ctx.device)
        logits, tokens, host_ms = [], [], []
        sent0 = dec.staging.sent
        _sync(ctx.device)
        ops.reset_launch_counts()
        for i in range(job.steps):
            t0 = time.perf_counter()
            lg, cache = step(mine, cache, {"tokens": tok,
                                           "exchange": (job.key, i)},
                             job.key + i)
            _sync(ctx.device)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            logits.append(lg)
            tokens.append(tok[:, 0])
        out.append({"logits": logits, "tokens": tokens, "cache": cache,
                    "stage": dec.stage, "data": dec.data,
                    "range": dec.ranges[dec.stage],
                    "stage_counts": dec.stage_counts,
                    "stage_devices": dec.stage_devices,
                    "launches": dict(ops.LAUNCHES), "host_ms": host_ms,
                    "sent_per_step": (dec.staging.sent - sent0)
                    / max(job.steps, 1)})
        del mine, cache, step
    if job.ping_iters and pods == 2:
        out.append({"boundary": _ping(ctx, dec, job)})
    return out


def _ping(ctx: RankContext, dec: PipelinedDecoder, job: DecodeJob) -> dict:
    """Mean host ms of one crossing of a sealed microbatch (cipher and
    scales of this data rank's rows) between the two pods: the whole
    crossing (``ms``), the same message between host tensors (``host_ms``:
    gloo alone) and the copies a card's message adds (``copy_ms``: into
    pinned memory on one side, out of it on the other)."""
    from repro_torch.launch import ranks as RK
    rows = job.tokens.shape[0] // job.num_microbatches // dec.num_data
    like = [torch.zeros((rows, job.cfg.d_model), dtype=torch.uint8),
            torch.zeros((rows, 1), dtype=torch.float32)]
    peer, group = dec._pod_ranks[1 - dec.stage], dec._pod_group
    staging = RK.Staging()

    def crossings(payload):
        for _ in range(3):                               # warm up
            RK.exchange(staging, payload, peer, group)
        _sync(ctx.device)
        t0 = time.perf_counter()
        for _ in range(job.ping_iters):
            # a round trip: stage 0 sends then receives, stage 1 the
            # reverse
            if dec.stage == 0:
                RK.send(staging, payload, peer, group).wait()
                payload = RK.recv(staging, payload, peer, group).wait()
            else:
                payload = RK.recv(staging, payload, peer, group).wait()
                RK.send(staging, payload, peer, group).wait()
        _sync(ctx.device)
        return (time.perf_counter() - t0) * 1e3 / (2 * job.ping_iters)

    out = {"ms": crossings([t.to(ctx.device) for t in like]),
           "host_ms": crossings(like)}
    if ctx.device.type == "cuda":
        cards = [t.to(ctx.device) for t in like]
        pinned = [t.pin_memory() for t in like]
        _sync(ctx.device)
        t0 = time.perf_counter()
        for _ in range(job.ping_iters):
            for c, h in zip(cards, pinned):
                h.copy_(c)
                c.copy_(h)
        _sync(ctx.device)
        out["copy_ms"] = (time.perf_counter() - t0) * 1e3 / job.ping_iters
    return out


# ---------------------------------------------------------------------------
# The serving engine over ranks
# ---------------------------------------------------------------------------
class KeyLedger:
    """Every (key, counter) this process seals under while it is open, with
    the window of the row each seal covers: ``ops.seal`` (a stage
    boundary) and ``ops.seal_bits`` (swaps, restages, prefill crossings,
    KV exchanges) are wrapped, keys and counters kept as given (device
    tensors cloned, read back at ``close``, so recording adds no host
    sync). Graph replays seal too: under a capture the wrapper notes its
    clones with the graph (``aot.capture_notes``, cloned inside it, so
    they hold each replay's key and counter) and a replay hook records
    them after every replay. A warm's repeated eager runs seal the same
    bytes under the same pair as its first run, which alone is kept."""

    def __init__(self):
        self.records: List[tuple] = []
        self._raw: List[tuple] = []

    def __enter__(self):
        self._real = (ops.seal, ops.seal_bits)
        real_seal, real_bits = self._real

        def keep(v):
            return v.detach().clone() if isinstance(v, torch.Tensor) else v

        def record(kind, key, counter, col0, cols, row_cols):
            if aot.repeat_run():
                return
            rec = (kind, keep(key), keep(counter), col0, cols, row_cols)
            notes = aot.capture_notes()
            (self._raw if notes is None else notes).append(rec)

        def seal(x, key, counter, *a, **kw):
            record("seal", key, counter, 0, x.shape[1], x.shape[1])
            return real_seal(x, key, counter, *a, **kw)

        def seal_bits(x, key, counter, col0=0, row_cols=None):
            record("seal_bits", key, counter, int(col0), x.shape[1],
                   x.shape[1] if row_cols is None else int(row_cols))
            return real_bits(x, key, counter, col0=col0, row_cols=row_cols)

        def replayed(graph):
            self._raw += [(kind, keep(key), keep(ctr), *rest)
                          for kind, key, ctr, *rest in graph.notes]

        self._hook = replayed
        aot.REPLAY_HOOKS.append(replayed)
        ops.seal, ops.seal_bits = seal, seal_bits
        return self

    def __exit__(self, *exc):
        aot.REPLAY_HOOKS.remove(self._hook)
        ops.seal, ops.seal_bits = self._real
        self.records += [(kind, int(key) & 0xFFFFFFFF,
                          int(ctr) & 0xFFFFFFFF, col0, cols, row_cols)
                         for kind, key, ctr, col0, cols, row_cols
                         in self._raw]
        self._raw = []


def keystream_reuse(ledgers: Sequence[Sequence[tuple]]) -> List[tuple]:
    """The (key, counter) pairs of ``KeyLedger`` records, one list a rank,
    that cipher two things under one keystream: a pair sealed twice on one
    rank, or on several ranks other than as disjoint column windows of one
    row width (the ranks' parts of one swap payload). Empty when none."""
    by_pair = {}
    for rank, recs in enumerate(ledgers):
        for kind, key, ctr, col0, cols, row_cols in recs:
            by_pair.setdefault((key, ctr), []).append(
                (rank, kind, col0, cols, row_cols))
    bad = []
    for pair, uses in by_pair.items():
        ranks = [u[0] for u in uses]
        spans = sorted((u[2], u[2] + u[3]) for u in uses)
        if len(set(ranks)) != len(ranks) \
                or len({(u[1], u[4]) for u in uses}) != 1 \
                or any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
            bad.append((pair, uses))
    return bad


@dataclasses.dataclass
class ServeRun:
    """One engine over one request stream: ``requests`` ``(prompt,
    max_new)``; with ``every`` > 0 one is submitted whenever the engine's
    step count is a multiple of ``every`` (the serve launcher's stream),
    with ``every`` 0 all up front and then ``run``. ``inject`` is a
    straggler ``(stage, factor)``; ``keep_logits`` keeps each decode step's
    logits (True) or the first N steps' (an int N); ``topology`` names a
    ``launch.serve.TOPOLOGIES`` entry; ``digest_steps`` digests the
    rank's cache after every engine step."""

    config: EngineConfig
    requests: Sequence[Tuple[Sequence[int], int]]
    every: int = 0
    inject: Optional[Tuple[int, float]] = None
    keep_logits: Union[bool, int] = False
    topology: str = "two-enclave"
    max_steps: int = 2000
    check_swaps: bool = False
    digest_steps: bool = False


@dataclasses.dataclass
class ServeJob:
    """``ServingEngine(mesh=)`` on each rank of a ``(world / data, data)``
    pod x data mesh, or with ``model`` > 1 a ``(world / (data * model),
    data, model)`` pod x data x model mesh (each stage's layers split
    over its model ranks, tensor parallelism inside a pod), over each of
    ``runs`` in turn. ``params`` the whole tree on the CPU, or None to
    draw it from ``seed`` on the rank's device (every rank draws the same
    bits); each rank keeps its stage's layers and its blocks of them."""

    cfg: ArchConfig
    runs: Sequence[ServeRun]
    dtype: torch.dtype = torch.float32
    params: Any = None
    seed: int = 0
    max_seq: int = 4096
    data: int = 1
    model: int = 1


def drive(eng, run: ServeRun):
    """Serve ``run``'s stream on ``eng``; returns the requests."""
    reqs, k, n = [], 0, len(run.requests)
    if run.every == 0:
        reqs = [eng.submit(list(p), m) for p, m in run.requests]
        eng.run(max_steps=run.max_steps)
        return reqs
    while k < n or eng.scheduler.has_work():
        if k < n and eng.steps % run.every == 0:
            reqs.append(eng.submit(list(run.requests[k][0]),
                                   run.requests[k][1]))
            k += 1
        moved = eng.step()
        if eng.stalled:
            break
        if k < n and not moved and not eng.scheduler.has_work():
            reqs.append(eng.submit(list(run.requests[k][0]),
                                   run.requests[k][1]))
            k += 1
        assert eng.steps < run.max_steps, "the stream did not drain"
    return reqs


class Probe:
    """An engine instrumented from outside for a ``serve`` run: host ms
    and bytes sent of each decode step (the backend's step and its
    sampling, between device synchronises), each decode step's logits
    (``keep`` True, or the first ``keep`` steps'), the stage probes run
    (``probes``), host ms of each swap-out and swap-in, the first
    swap-out's payload, digest, layout and counter, and (``check``) every
    swap-in's pages against the rows
    gathered at its swap-out (the first swap-out's in ``first_rows``),
    bit for bit (``restored`` pages; a swap-in
    whose stage layout moved since is counted in ``moved`` instead); with
    ``digest``, a ``param_digest`` of the backend's cache after every
    engine step (``digests``); over a model axis (``tp``, the rank's
    ``ModelAxis``) the bytes each decode step put into the model group's
    collectives (``model_bytes``: (the layers' reduces, gathers and the
    crossing's broadcast; the flash-decode's query gathers; its partial
    combines) a step). On a rank engine, the layers the rank held at each
    decode step (``step_layers``), stage probe (``probe_layers``) and
    prefill call (``prefill_layers``: (kind, layers)), from which its
    kernel launches are reckoned across a live re-plan."""

    def __init__(self, eng, keep: bool, check: bool = False,
                 digest: bool = False, tp=None):
        self.step_ms, self.step_bytes, self.logits = [], [], []
        self.model_bytes = []
        model = (lambda: (tp.staging.collective, tp.q_gather.collective,
                          tp.combine.collective)) if tp is not None \
            else (lambda: (0, 0, 0))
        self.swap_out_ms, self.swap_in_ms = [], []
        self.first_swap, self.digests = None, []
        self.first_rows = None
        self.probes = self.restored = self.moved = 0
        self.step_layers, self.probe_layers, self.prefill_layers = [], [], []
        be, dev = eng.backend, eng.device
        ranked = hasattr(be, "_forward")

        def layers():
            if not ranked:
                return None
            lo, hi = be.dec.ranges[be.stage]
            return hi - lo
        staging = getattr(be, "staging", None)
        step, sample, times = be.step, eng._sample, be.stage_times
        pending = []

        def timed_step(tokens, key):
            _sync(dev)
            pending[:] = [time.perf_counter(),
                          staging.sent if staging else 0]
            at = model()
            self.step_layers.append(layers())
            out = step(tokens, key)
            self.model_bytes.append(tuple(b - a for a, b in zip(at,
                                                                model())))
            if keep is True or len(self.logits) < keep:
                self.logits.append(out.detach().cpu())
            return out

        def timed_sample(logits, rids, idxs):
            out = sample(logits, rids, idxs)
            if pending:
                self.step_ms.append((time.perf_counter() - pending[0]) * 1e3)
                self.step_bytes.append(
                    (staging.sent if staging else 0) - pending[1])
                pending.clear()
            return out

        def counted_times():
            self.probes += 1
            self.probe_layers.append(layers())
            return times()

        if ranked:
            forward = be._forward

            def counted_forward(kind, inputs):
                self.prefill_layers.append((kind, layers()))
                return forward(kind, inputs)

            be._forward = counted_forward

        swap_out, swap_in = eng._preempt_swap, eng._swap_in

        def timed_out(slot, req):
            t0 = time.perf_counter()
            swap_out(slot, req)
            self.swap_out_ms.append((time.perf_counter() - t0) * 1e3)
            if self.first_swap is None:
                man = eng.pool.swap_manifest[req.rid]
                self.first_swap = dict(payload=tuple(man.payload),
                                       digest=man.digest,
                                       layout=man.layout,
                                       counter=man.counter, key=eng._key)

        def timed_in(slot, req, t0):
            t = time.perf_counter()
            ok = swap_in(slot, req, t0)
            self.swap_in_ms.append((time.perf_counter() - t) * 1e3)
            return ok

        be.step, eng._sample, be.stage_times = (timed_step, timed_sample,
                                                counted_times)
        eng._preempt_swap, eng._swap_in = timed_out, timed_in
        if check:
            self._check_swaps(be)
        if digest:
            engine_step = eng.step

            def digested_step():
                out = engine_step()
                self.digests.append(param_digest(be.cache))
                return out

            eng.step = digested_step

    def _check_swaps(self, be) -> None:
        gather, scatter = be.gather_pages, be.scatter_pages
        gathered = {}

        def current():
            return getattr(be, "dec", None) and be.dec.ranges

        def checked_gather(pages, key, ctr):
            pg = torch.as_tensor(np.asarray(pages, np.int64),
                                 device=be.device)
            gathered[ctr] = (current(), [pool[:, pg].clone()
                                         for pool in be.body])
            if self.first_rows is None:
                self.first_rows = gathered[ctr][1]
            return gather(pages, key, ctr)

        def checked_scatter(ck, cv, pages, key, ctr, **layout):
            scatter(ck, cv, pages, key, ctr, **layout)
            then, rows = gathered.pop(ctr)
            if then != current():
                self.moved += 1
                return
            for i, pg in enumerate(pages):
                if pg < be.num_pages:
                    for pool, r in zip(be.body, rows):
                        assert torch.equal(pool[:, int(pg)], r[:, i]), \
                            f"swap-in of page {pg} (row {i}) not bit-exact"
                    self.restored += 1

        be.gather_pages, be.scatter_pages = checked_gather, checked_scatter


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _events(eng) -> List[tuple]:
    return [(e.step, e.kind, e.detail) for e in eng.events]


def serve(ctx: RankContext, job: ServeJob) -> List[dict]:
    """One result a run: ``streams``, ``events`` and ``stats()``; the
    rank's ``stage`` and final ``range``; ``launches`` over the run; host
    ``step_ms`` and ``step_bytes`` a decode step (``Probe``), the engine's
    admission ms (rank 0's, as every rank records them); ``crossings`` and
    ``restages`` (host ms, bytes this rank sent) each; swap-out and
    swap-in host ms; the first swap-out (``first_swap``: this rank's
    payload part, its digest, layout and counter); the decode ``logits``
    with ``keep_logits``; ``probes`` (stage-probe runs), ``restored`` and
    ``moved`` (``Probe``), ``decode_steps``, ``relayouts``; ``keys``,
    every (kind, key, counter, col0, cols, row_cols) this rank sealed
    under (``KeyLedger``); its ``data`` index (``stage`` is its pod's); the KV
    ``exchanges`` between data ranks (host ms, bytes sent) a decode step;
    a ``param_digest`` of its cache after the run (``cache_digest``) and,
    with ``digest_steps``, after every engine step (``digests``). Its
    warmup (``EngineConfig(warmup=True)``, run inside the ledger): the
    rank's ``graphs``, ``warmup_s``, ``post_warmup_compiles`` and
    ``stalls`` (each rank captures its own stage's work), and each decode
    step's host ms in its device segments and in its messages
    (``step_splits``, ``PipelinedDecoder.rank_loop``); on a card the
    run's ``peak_reserved`` device bytes."""
    from repro_torch.launch.serve import TOPOLOGIES
    api, params = _model(ctx, job.cfg, job.dtype, job.params, job.seed,
                         job.max_seq)
    params = map_tree(lambda t: t.cpu(), params)
    _sync(ctx.device)
    if job.model > 1:
        mesh = make_mesh((ctx.world // (job.data * job.model), job.data,
                          job.model), ("pod", "data", "model"),
                         device=ctx.device)
    else:
        mesh = make_mesh((ctx.world // job.data, job.data), ("pod", "data"),
                         device=ctx.device)
    tp = TP.axis_of(mesh)
    out = []
    for run in job.runs:
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        with KeyLedger() as ledger:
            eng = ServingEngine(api, run.config, params, device=ctx.device,
                                rm=TOPOLOGIES[run.topology](
                                    run.config.num_stages),
                                backend="pipelined", mesh=mesh)
            if run.inject:
                eng.telemetry.inject(*run.inject)
            probe = Probe(eng, run.keep_logits, run.check_swaps,
                          run.digest_steps, tp)
            _sync(ctx.device)
            ops.reset_launch_counts()
            reqs = drive(eng, run)
            _sync(ctx.device)
            launches = dict(ops.LAUNCHES)
        be = eng.backend
        out.append({
            "streams": [list(r.generated) for r in reqs],
            "status": [r.status for r in reqs],
            "events": _events(eng), "stats": eng.stats(),
            "stage": be.stage, "data": be.data,
            "range": be.dec.ranges[be.stage],
            "launches": launches, "step_ms": probe.step_ms,
            "step_bytes": probe.step_bytes,
            "admission_ms": list(eng.admission_ms),
            "crossings": list(be.crossings), "restages": list(be.restages),
            "relayouts": getattr(be, "relayouts", 0),
            "swap_out_ms": probe.swap_out_ms,
            "swap_in_ms": probe.swap_in_ms,
            "first_swap": probe.first_swap, "logits": probe.logits,
            "first_rows": probe.first_rows,
            "probes": probe.probes, "restored": probe.restored,
            "moved": probe.moved, "decode_steps": be.steps,
            "exchanges": list(be.exchanges),
            "cache_digest": param_digest(be.cache),
            "digests": probe.digests, "keys": ledger.records,
            "graphs": eng.aot.graphs, "warmup_s": eng.warmup_s,
            "post_warmup_compiles": eng.aot.post_freeze_compiles,
            "stalls": [x.describe() for x in eng.aot.post_freeze_stalls],
            "step_splits": list(be.step_splits),
            "model": be.dec.model, "model_bytes": probe.model_bytes,
            "step_layers": probe.step_layers,
            "probe_layers": probe.probe_layers,
            "prefill_layers": probe.prefill_layers,
            "param_bytes": _nbytes(be.params),
            "kv_bytes": _nbytes(be.body if be.paged else be.cache[
                api.model.served_segment.name]),
            "param_shapes": [tuple(t.shape) for t in leaves(be.params)],
            "kv_shapes": [tuple(t.shape) for t in leaves(
                be.body if be.paged else be.cache[
                    api.model.served_segment.name])],
            "peak_reserved": torch.cuda.max_memory_reserved(ctx.device)
            if ctx.device.type == "cuda" else 0})
        del eng, be, probe
        # the engine's graphs go now, not inside the next one's captures
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# The disaggregated pair over ranks
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DisaggRun:
    """The prefill/decode pair (``build_disagg(mesh=)``) over one request
    stream: ``requests`` ``(prompt, max_new)``; with ``every`` > 0 one is
    submitted whenever the decode role's step count is a multiple of
    ``every`` (the serve launcher's ``serve_stream_orch``), with ``every``
    0 all up front and then ``run``. ``config`` seeds both roles (faults
    and warmup included); ``inject`` is a straggler ``(stage, factor)`` on
    the decode role's telemetry (a live re-plan there, so later handoffs
    relayout)."""

    config: EngineConfig
    requests: Sequence[Tuple[Sequence[int], int]]
    every: int = 0
    inject: Optional[Tuple[int, float]] = None


PAIR_MAX_TICKS = 2000       # an up-front stream drains within this


def drive_pair(orch, run: DisaggRun):
    """Serve ``run``'s stream through the orchestrator ``orch``; returns the
    requests."""
    from repro_torch.launch.serve import serve_stream_orch
    if run.every:
        return serve_stream_orch(orch, run.requests, run.every)
    reqs = [orch.submit(list(p), m) for p, m in run.requests]
    orch.run(max_steps=PAIR_MAX_TICKS)
    return reqs


def _row_digests(rows: torch.Tensor) -> torch.Tensor:
    """[layers, n, ...] -> int64 [layers, n]: each (layer, row) slice's
    ``param_digest`` (bit patterns times odd weights of their positions,
    summed with wrapping), so two slices with equal digests hold the same
    bits but with a vanishing chance."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    flat = rows.reshape(rows.shape[0], rows.shape[1], -1)
    bits = flat.contiguous().view(ints[rows.element_size()]).to(torch.int64)
    w = torch.arange(bits.shape[-1], dtype=torch.int64,
                     device=bits.device).mul_(2).add_(1)
    return (bits * w).sum(-1).cpu()


class PairProbe:
    """A pair instrumented from outside: the decode role's ``Probe``
    (``decode``: host ms a decode step, stage probes, a ``param_digest``
    of its cache after every tick); host ms, this rank's part bytes and
    bytes messaged of each export (``exports``) and each transfer-in
    (``transfers_in``, and whether it restored), between device
    synchronises, less the time the row digests below took; the first
    handoff's part (``first_handoff``: payload, digest, layout, counter);
    a digest of every transferred (layer, page row) as the prefill role
    gathered it (``gathered``) and as the decode role restored it
    (``restored``, the rows that landed), keyed by (counter, part, layer,
    row), for the layers this rank holds in each role; the orchestrator's
    decisions after every tick (``decisions``: clock, back-pressure
    events, handoffs, the in-flight ladder). On one card ``layer`` runs
    over every layer."""

    def __init__(self, orch):
        pre, dec = orch.eng_prefill, orch.decode
        self.decode = Probe(dec, keep=False, digest=True)
        self.exports, self.transfers_in = [], []
        self.first_handoff = None
        self.gathered, self.restored = {}, {}
        self.decisions = []
        self._watch_ms = 0.0        # host ms the row digests took
        dev = dec.device
        export, transfer_in = pre.export_transfer, dec._transfer_in

        def sent(eng):
            st = getattr(eng.backend, "staging", None)
            return st.sent if st is not None else 0

        def timed_export(slot):
            _sync(dev)
            t0, s0, w0 = time.perf_counter(), sent(pre), self._watch_ms
            req, man = export(slot)
            _sync(dev)
            self.exports.append(((time.perf_counter() - t0) * 1e3
                                 - (self._watch_ms - w0),
                                 sum(p.nbytes for p in man.payload),
                                 sent(pre) - s0))
            if self.first_handoff is None:
                self.first_handoff = dict(
                    payload=tuple(man.payload), digest=man.digest,
                    layout=man.layout, counter=man.counter)
            return req, man

        def timed_in(slot, req, t0):
            man = dec.pool.transfer_manifest[req.rid]
            _sync(dev)
            t, s0, w0 = time.perf_counter(), sent(dec), self._watch_ms
            ok = transfer_in(slot, req, t0)
            _sync(dev)
            self.transfers_in.append(((time.perf_counter() - t) * 1e3
                                      - (self._watch_ms - w0),
                                      sum(p.nbytes for p in man.payload),
                                      sent(dec) - s0, ok))
            if not ok:          # fresh pages released: nothing restored
                for k in [k for k in self.restored if k[0] == man.counter]:
                    del self.restored[k]
            return ok

        pre.export_transfer, dec._transfer_in = timed_export, timed_in
        self._watch_rows(pre.backend, dec.backend, dec.pool.num_pages)
        step = orch.step

        def observed_step():
            step()
            self.decisions.append((
                orch.clock, orch.backpressure_events, orch.handoffs,
                [(e[0].rid, e[2], e[3], e[4], e[5])
                 for e in orch._in_flight]))

        orch.step = observed_step

    @staticmethod
    def _span(be):
        dec = getattr(be, "dec", None)
        if dec is None or dec.mesh is None:
            return 0
        return dec.ranges[dec.stage][0]

    def _watch_rows(self, pre_be, dec_be, num_pages: int) -> None:
        from repro_torch.enclave import sealing
        gather, scatter = pre_be.gather_pages, dec_be.scatter_pages

        def watched_gather(pages, key, ctr):
            if ctr >= sealing.TRANSFER_SEQ_BASE:
                _sync(pre_be.device)
                t0 = time.perf_counter()
                pg = torch.as_tensor(np.asarray(pages, np.int64),
                                     device=pre_be.device)
                lo = self._span(pre_be)
                for part, pool in enumerate(pre_be.body):
                    d = _row_digests(pool[:, pg])
                    for i in range(d.shape[0]):
                        for r in range(d.shape[1]):
                            self.gathered[(ctr, part, lo + i, r)] = \
                                int(d[i, r])
                self._watch_ms += (time.perf_counter() - t0) * 1e3
            return gather(pages, key, ctr)

        def watched_scatter(ck, cv, pages, key, ctr, **layout):
            scatter(ck, cv, pages, key, ctr, **layout)
            if ctr < sealing.TRANSFER_SEQ_BASE:
                return
            _sync(dec_be.device)
            t0 = time.perf_counter()
            rows = [r for r, pg in enumerate(pages) if pg < num_pages]
            pg = torch.as_tensor([int(pages[r]) for r in rows],
                                 dtype=torch.int64, device=dec_be.device)
            lo = self._span(dec_be)
            for part, pool in enumerate(dec_be.body):
                d = _row_digests(pool[:, pg])
                for i in range(d.shape[0]):
                    for j, r in enumerate(rows):
                        self.restored[(ctr, part, lo + i, r)] = int(d[i, j])
            self._watch_ms += (time.perf_counter() - t0) * 1e3

        pre_be.gather_pages, dec_be.scatter_pages = (watched_gather,
                                                     watched_scatter)


def rows_restored(ranks: Sequence[dict]) -> List[int]:
    """Each rank's transferred (layer, page row) pairs whose restored bits
    equal the bits the prefill role gathered (``PairProbe`` digests of
    every rank's results, one dict a rank with ``gathered`` and
    ``restored``); raises on a row restored otherwise, or gathered
    differently by two ranks that held its layer."""
    gathered = {}
    for r in ranks:
        for k, d in r["gathered"].items():
            assert gathered.setdefault(k, d) == d, \
                ("two ranks gathered one row differently", k)
    out = []
    for r in ranks:
        for k, d in r["restored"].items():
            assert k in gathered and gathered[k] == d, \
                ("a transferred row not restored bit for bit", k)
        out.append(len(r["restored"]))
    return out


@dataclasses.dataclass
class DisaggJob:
    """``build_disagg(mesh=)`` on each rank of a ``(world / data, data)``
    pod x data mesh, over each of ``runs`` in turn. ``params`` on the CPU,
    or None to draw them from ``seed`` on the rank's device."""

    cfg: ArchConfig
    runs: Sequence[DisaggRun]
    dtype: torch.dtype = torch.float32
    params: Any = None
    seed: int = 0
    max_seq: int = 4096
    data: int = 1


def _role(eng) -> dict:
    """What a rank keeps of one role: its stats and events, graphs, warmup
    and post-warmup counts, its stage, data index, final range and decode
    steps."""
    be = eng.backend
    return {"stats": eng.stats(), "events": _events(eng),
            "graphs": eng.aot.graphs, "warmup_s": eng.warmup_s,
            "post_warmup_compiles": eng.aot.post_freeze_compiles,
            "stalls": [x.describe() for x in eng.aot.post_freeze_stalls],
            "stage": be.stage, "data": be.data,
            "range": be.dec.ranges[be.stage], "decode_steps": be.steps}


def disagg(ctx: RankContext, job: DisaggJob) -> List[dict]:
    """One result a run: ``streams`` and ``status``; ``orch`` (the
    orchestrator's ``stats()``); ``decode`` and ``prefill`` (``_role``: each
    role's stats, events, graphs, warmup, post-warmup captures and stalls,
    stage, final range and decode steps); ``launches`` over the run (construction and warmup
    excluded); the ``PairProbe`` figures (``exports``, ``transfers_in``,
    ``first_handoff``, ``gathered``, ``restored``, ``decisions``,
    ``digests``, ``step_ms``, ``probes``); the decode role's
    ``relayouts`` and final ``cache_digest``; ``keys``, every (kind, key, counter, col0, cols,
    row_cols) this rank sealed under, both roles, construction and warmup
    included (``KeyLedger``); the decode role's ``admission_ms``; on a card
    the run's ``peak_reserved`` device bytes, both roles on the rank."""
    from repro_torch.launch.serve import TOPOLOGIES
    from repro_torch.serving.disagg import build_disagg
    rm = TOPOLOGIES["two-enclave"]
    api, params = _model(ctx, job.cfg, job.dtype, job.params, job.seed,
                         job.max_seq)
    params = map_tree(lambda t: t.cpu(), params)
    _sync(ctx.device)
    mesh = make_mesh((ctx.world // job.data, job.data), ("pod", "data"),
                     device=ctx.device)
    out = []
    for run in job.runs:
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        with KeyLedger() as ledger:
            orch = build_disagg(api, params, config=run.config,
                                backend="pipelined", mesh=mesh,
                                device=ctx.device,
                                rm=rm(run.config.num_stages))
            if run.inject:
                orch.decode.telemetry.inject(*run.inject)
            probe = PairProbe(orch)
            _sync(ctx.device)
            ops.reset_launch_counts()
            reqs = drive_pair(orch, run)
            _sync(ctx.device)
            launches = dict(ops.LAUNCHES)
        orch.check_invariants()
        dec = orch.decode
        out.append({
            "streams": [list(r.generated) for r in reqs],
            "status": [r.status for r in reqs],
            "orch": orch.stats(), "decode": _role(dec),
            "prefill": _role(orch.eng_prefill), "launches": launches,
            "exports": probe.exports, "transfers_in": probe.transfers_in,
            "first_handoff": probe.first_handoff,
            "step_ms": probe.decode.step_ms, "probes": probe.decode.probes,
            "gathered": probe.gathered, "restored": probe.restored,
            "decisions": probe.decisions, "digests": probe.decode.digests,
            "relayouts": dec.backend.relayouts,
            "cache_digest": param_digest(dec.backend.cache),
            "keys": ledger.records,
            "admission_ms": list(dec.admission_ms),
            "peak_reserved": torch.cuda.max_memory_reserved(ctx.device)
            if ctx.device.type == "cuda" else 0})
        del orch, dec, probe
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# The serve steps over ranks
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepsJob:
    """The prefill and decode serve steps (``runtime.steps``) over a mesh
    of pod, data and model ranks: ``make_prefill_step`` at ``ShapeConfig("p",
    seq, batch, "prefill")`` on ``tokens`` [batch, seq] (on the CPU),
    then ``steps`` greedy ``make_decode_step`` calls at ``ShapeConfig("d",
    seq + steps, batch, "decode")`` on the prefilled cache grown by
    ``steps`` positions (``grow_cache``). ``params`` the whole tree on the
    CPU (each rank keeps its shard, ``shard_params``), or None to draw the
    rank's shard from ``seed`` on its device (``draw_params``).
    ``indivisible``, when not 0, is a global batch the steps must refuse
    by name. ``act_rules``, ``param_rules`` and ``sharded_logits`` go to
    the steps (the param rules also to the rank's blocks); ``feed``
    ([steps, batch, 1] int32), when given, holds the tokens the decode
    steps take in place of the greedy ones (a rank's sharded logits hold
    only its block). With ``plain_decode`` each decode step is also run,
    untimed and first, by a decode step built without ``act_rules`` on a
    copy of the same cache and the same tokens. ``horizon``, when not 0,
    is the decode steps' cache length in place of ``seq + steps``."""

    cfg: ArchConfig
    mesh: Mesh
    tokens: torch.Tensor
    steps: int = 1
    horizon: int = 0
    dtype: torch.dtype = torch.float32
    params: Any = None
    seed: int = 0
    max_seq: int = 4096
    indivisible: int = 0
    param_rules: Optional[dict] = None
    sharded_logits: bool = False
    feed: Optional[torch.Tensor] = None
    act_rules: Optional[dict] = None
    plain_decode: bool = False


def grow_cache(api, cache, n: int, mesh=None, split_in: int = 0,
               split_out: int = 0):
    """A timeline cache from a prefill with ``n`` more zero positions on
    every leaf's KV time axis (new tensors), in every segment. Over the
    model axis of ``mesh``, a cache that holds the rank's block of the
    positions (``split_in``, the prefill step's ``positions``, its
    horizon or 0) is first gathered whole over the model group, and the
    grown one keeps the rank's block (``split_out``, the decode step's),
    as the reference's test puts the grown cache under the decode step's
    ``cache_shardings``."""
    out = dict(cache)
    for seg in api.model.segments:
        axes = iter(axes_leaves(api.model.init_cache_axes()[seg.name]))

        def grow(t):
            ax = next(axes)
            if "act_kv_seq" not in ax:
                return t.clone()
            d = ax.index("act_kv_seq")
            if split_in:
                with R.axis_rules(mesh):
                    t = TP.gather_model(t, d)
            pad = [0, 0] * (t.dim() - 1 - d) + [0, n]
            return torch.nn.functional.pad(t, pad)

        out[seg.name] = map_tree(grow, cache[seg.name])
    if split_out:
        with R.axis_rules(mesh), TP.kv_positions(split_out):
            out = S.keep_positions(api, out)
    return out


def _messaged(*steps) -> int:
    """Bytes the steps' ``Staging`` buffers have messaged so far."""
    seen = {id(st): st for f in steps for st in f.stagings}
    return sum(st.sent + st.collective for st in seen.values())


def _gathered(step) -> int:
    """Bytes the data axis's gathers have put in so far (every step on a
    mesh shares them; 0 without a data axis)."""
    st = step.gather_staging
    return st.collective if st is not None else 0


def _seq_bytes(mesh) -> Tuple[int, int]:
    """Bytes the sequence's gathers and reduce-scatters over the model
    axis of ``mesh`` have put in so far (every step on the mesh shares
    them; 0 without a model axis)."""
    tp = TP.axis_of(mesh)
    if tp is None:
        return 0, 0
    return tp.seq_gather.collective, tp.seq_scatter.collective


def _flash_bytes(mesh) -> Tuple[int, int]:
    """Bytes the distributed flash-decode's query gathers and partial
    combines over the model axis of ``mesh`` have put in so far (0, 0
    without a model axis)."""
    tp = TP.axis_of(mesh)
    if tp is None:
        return 0, 0
    return tp.q_gather.collective, tp.combine.collective


def serve_steps(ctx: RankContext, job: StepsJob) -> dict:
    """This rank's ``rows`` (a slice of the global batch), the whole [B, V]
    ``logits`` of the prefill and of each decode step, its
    ``prefill_cache`` and its final ``cache`` (its rows, its shard on a
    model axis), host ms of the prefill and of each decode step
    (``prefill_ms``, ``decode_ms``; a first prefill and decode step run
    untimed before them), the bytes each of them messaged
    (``prefill_bytes``, ``decode_bytes``) and, of those, the bytes of its
    gathers of the params' data blocks (``prefill_gather_bytes``,
    ``decode_gather_bytes``) and of the sequence's gathers and
    reduce-scatters over the model axis (``prefill_seq_bytes``,
    ``decode_seq_bytes``: a (gathers, reduce-scatters) pair each;
    under ``SP_ACT_RULES``) and of the distributed flash-decode
    (``decode_flash_bytes``: (query gathers, partial combines) a step;
    where the positions split over model), with ``plain_decode`` the other decode
    step's logits (``plain_decode_logits``), ``launches`` over them, the
    rank's
    ``param_bytes`` and ``param_shapes`` (its blocks, in leaf order),
    ``peak_bytes`` (the card's peak allocation over the driven steps;
    None on the CPU) and, with ``indivisible``, the refusal's message
    (``refusal``)."""
    B, Sq = tuple(job.tokens.shape)
    api = build_model(job.cfg, device=ctx.device, dtype=job.dtype,
                      max_seq=job.max_seq)
    mesh = make_mesh(*job.mesh, device=ctx.device)
    out = {"logits": [], "decode_ms": [], "decode_bytes": [],
           "decode_gather_bytes": [], "decode_seq_bytes": [],
           "decode_flash_bytes": []}
    params = _rank_params(ctx, api, mesh, job.params, job.seed,
                          job.param_rules)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in leaves(params))
    out["param_shapes"] = [tuple(t.shape) for t in leaves(params)]
    kw = dict(act_rules=job.act_rules, param_rules=job.param_rules,
              sharded_logits=job.sharded_logits)
    pre = S.make_prefill_step(api, mesh, ShapeConfig("p", Sq, B, "prefill"),
                              **kw)
    horizon = job.horizon or Sq + job.steps
    dshape = ShapeConfig("d", horizon, B, "decode")
    dec = S.make_decode_step(api, mesh, dshape, **kw)
    plain = S.make_decode_step(api, mesh, dshape, **dict(
        kw, act_rules=None)) if job.plain_decode else None
    idx, count = S._rank_rows(mesh, ("pod", "data"), B)
    out["rows"] = slice(idx * B // count, (idx + 1) * B // count)
    tok = job.tokens.to(ctx.device)
    # first calls, untimed (the rank's first cuBLAS calls and kernel
    # loads), on copies
    def next_tokens(logits, i):
        if job.feed is not None:
            return job.feed[i].to(ctx.device)
        return logits.argmax(-1)[:, None].to(torch.int32)

    def grown(cache):
        return grow_cache(api, cache, horizon - Sq, mesh, pre.positions,
                          dec.positions)

    logits, cache = pre(params, {"tokens": tok})
    dec(params, grown(cache), {"tokens": next_tokens(logits, 0)})
    del logits, cache
    _sync(ctx.device)
    ops.reset_launch_counts()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    sent, gathered, seq = _messaged(pre, dec), _gathered(pre), \
        _seq_bytes(mesh)
    t0 = time.perf_counter()
    logits, cache = pre(params, {"tokens": tok})
    _sync(ctx.device)
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_bytes"] = _messaged(pre, dec) - sent
    out["prefill_gather_bytes"] = _gathered(pre) - gathered
    out["prefill_seq_bytes"] = tuple(
        b - a for a, b in zip(seq, _seq_bytes(mesh)))
    out["logits"].append(logits)
    out["prefill_cache"] = map_tree(lambda t: t.clone(), cache)
    cache = grown(cache)
    for i in range(job.steps):
        tok = next_tokens(logits, i)
        if plain is not None:
            out.setdefault("plain_decode_logits", []).append(plain(
                params, map_tree(lambda t: t.clone(), cache),
                {"tokens": tok})[0])
        sent, gathered, seq = _messaged(pre, dec), _gathered(pre), \
            _seq_bytes(mesh)
        flash = _flash_bytes(mesh)
        t0 = time.perf_counter()
        logits, cache = dec(params, cache, {"tokens": tok})
        _sync(ctx.device)
        out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        out["decode_flash_bytes"].append(tuple(
            b - a for a, b in zip(flash, _flash_bytes(mesh))))
        out["decode_bytes"].append(_messaged(pre, dec) - sent)
        out["decode_gather_bytes"].append(_gathered(pre) - gathered)
        out["decode_seq_bytes"].append(tuple(
            b - a for a, b in zip(seq, _seq_bytes(mesh))))
        out["logits"].append(logits)
    out["cache"] = cache
    out["launches"] = dict(ops.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else None
    if job.indivisible:
        try:
            S.make_prefill_step(api, mesh, ShapeConfig(
                "p", Sq, job.indivisible, "prefill"))
        except ValueError as e:
            out["refusal"] = str(e)
    return out


def chain(ctx: RankContext, calls: Sequence[Tuple[Callable, Any]]
          ) -> List[Any]:
    """``fn(ctx, job)`` for each ``(fn, job)`` of ``calls`` in turn, in one
    set of ranks (each ``fn`` a body of this module). On a card the
    allocator's cached blocks are released after each call, so four ranks
    sharing it do not each keep one call's peak reserved for the next."""
    out = []
    for fn, job in calls:
        out.append(fn(ctx, job))
        if ctx.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The train step over ranks
# ---------------------------------------------------------------------------
def pod_exchange(ctx: RankContext, cases) -> List[tuple]:
    """Each case holds one ``(grads, ef)`` pair a rank; pod ``ctx.rank``
    puts its pair through ``compressed_psum_pod`` over the world's ranks,
    one a pod. Returns (reduced grads, new ef, bytes this rank sent) a
    case."""
    import torch.distributed as dist
    out = []
    for trees in cases:
        staging = Staging()
        g, e = trees[ctx.rank]
        reduced, ef = compressed_psum_pod(g, e, dist.group.WORLD, ctx.world,
                                          staging)
        out.append((reduced, ef, staging.sent))
    return out


# ---------------------------------------------------------------------------
# The train step over ranks (the whole step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainJob:
    """``steps`` train steps of ``make_train_step(mesh=)`` (compressed with
    ``compressed``) over ``SyntheticTokenStream(vocab, batch, seq,
    structure=structure)``, every step's batch with
    ``label_mask`` [batch, seq] when given. ``params`` the whole tree on
    the CPU, or None to draw them from ``seed`` on the rank's device (on a
    model axis each rank keeps or draws its shards), then ``prepare(api,
    params)`` when given."""

    cfg: ArchConfig
    mesh: Mesh
    steps: int
    batch: int
    seq: int
    opt: AdamWConfig = AdamWConfig()
    compressed: bool = False
    dtype: torch.dtype = torch.float32
    params: Any = None
    seed: int = 0
    structure: float = 0.9
    label_mask: Optional[np.ndarray] = None
    # the state returned: "params" (final), "ef" (after every step,
    # compressed)
    keep: Tuple[str, ...] = ("params", "ef")
    # fn(api, params) -> params, on the rank's params before step 1
    prepare: Optional[Callable] = None
    # the step's param_rules (the rank's blocks with them); None: PARAM_RULES
    param_rules: Optional[dict] = None
    # before step 1: whether the rank's data blocks, gathered over its data
    # group, are its model index's shard of the same draw (``layout_ok``)
    check_layout: bool = False
    # the step's act_rules (SP_ACT_RULES: the sequence split over model);
    # None: ACT_RULES
    act_rules: Optional[dict] = None
    # a file (``torch.save``) of the list of whole leaves of a first
    # moment to hold the rank's against (``m_err``), or None
    against: Optional[str] = None


def _layout_ok(ctx: RankContext, api, mesh, job: TrainJob, params) -> bool:
    """Whether ``params`` (the rank's blocks), gathered whole over its data
    group, equal its model index's shard of the same weights (the blocks
    of the rules with every leaf whole over data), bit for bit."""
    rules = R.merge_rules(job.param_rules or R.PARAM_RULES, {"embed": [()]})
    shard = _rank_params(ctx, api, mesh, job.params, job.seed, rules)
    if job.prepare is not None:
        shard = job.prepare(api, shard)
    layout = S.DataLayout(api, mesh, job.param_rules)
    dims = layout.dims or map_tree(lambda _: None, params)
    with torch.no_grad():
        # every leaf, so that every rank runs every gather
        same = [torch.equal(FS.gather_data(t, d, layout.blocks), w)
                for t, d, w in zip(leaves(params), leaves(dims),
                                   leaves(shard))]
    return all(same)


def _rank_params(ctx: RankContext, api, mesh, params, seed: int,
                 rules=None):
    """This rank's params on ``mesh``: its blocks of the whole tree
    ``params`` (on the CPU; ``shard_params`` under ``rules``) moved to
    its device, or drawn there from ``seed`` (``draw_params``)."""
    if params is None:
        return S.draw_params(api, mesh, torch.Generator(
            device=ctx.device).manual_seed(seed), rules)
    return map_tree(lambda t: t.to(ctx.device, copy=True),
                    S.shard_params(api, mesh, params, rules))


def train(ctx: RankContext, job: TrainJob) -> dict:
    """The rank's ``losses`` and ``gnorms`` a step, a ``param_digest`` of
    its params after each step (``digests``, one int a leaf; ``split``
    names, a leaf, the mesh axes that split it: a leaf's block holds the
    same bits on every rank with its coordinates on those axes),
    ``param_bytes`` and ``param_shapes`` (its blocks), ``opt_shapes``
    (AdamW's master, ``m`` and ``v``), ``layout_ok`` (``check_layout``),
    ``launches``,
    ``host_ms`` a step, the bytes it sent point to point a step
    (``sent_per_step``), the bytes a step of its data reduce of whole
    leaves, pod sums and pod exchange (``data_bytes_per_step``), of its
    model axis's collectives (``model_bytes_per_step``), of its gathers
    of the params' data blocks (``gather_bytes_per_step``) and of their
    gradients' reduce-scatters (``scatter_bytes_per_step``), under a
    sequence split (``act_rules``) of the sequence's gathers
    (``seq_gather_bytes_per_step``) and reduce-scatters
    (``seq_scatter_bytes_per_step``) over the model axis, apart from
    ``model_bytes_per_step``, and of the norms' sum over the model group
    (``norms_bytes_per_step``; all three 0 without one), its peak device
    memory (a card), the error feedback's largest |value| and nonzero
    count (compressed), and as ``keep`` names them the final ``params``
    and the ``ef`` after every step (``ef_steps``); with ``against``,
    AdamW's final first moment held against the saved one (``m_err``,
    one number a leaf, ``held_against``). On a mesh of
    ranks the params are the rank's blocks (of ``params``, or drawn from
    ``seed``)."""
    mesh = make_mesh(*job.mesh, device=ctx.device)
    api = build_model(job.cfg, device=ctx.device, dtype=job.dtype,
                      max_seq=job.seq)
    params = _rank_params(ctx, api, mesh, job.params, job.seed,
                          job.param_rules)
    if job.prepare is not None:
        params = job.prepare(api, params)
    layout_ok = _layout_ok(ctx, api, mesh, job, params) \
        if job.check_layout else None
    opt = adamw.init(params)
    extra = (init_error_feedback(params),) if job.compressed else ()
    step = S.make_train_step(api, job.opt,
                             ShapeConfig("ranks", job.seq, job.batch,
                                         "train"),
                             device=ctx.device, mesh=mesh,
                             compress_pod_grads=job.compressed,
                             act_rules=job.act_rules,
                             param_rules=job.param_rules)
    data = SyntheticTokenStream(job.cfg.vocab_size, job.batch, job.seq,
                                structure=job.structure)
    res = {"losses": [], "gnorms": [], "digests": [], "host_ms": [],
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params))}
    res["param_shapes"] = [tuple(t.shape) for t in leaves(params)]
    res["opt_shapes"] = [[tuple(t.shape) for t in leaves(tree)]
                         for tree in opt]
    res["layout_ok"] = layout_ok
    res["split"] = S.split_axes(api, mesh, job.param_rules)
    tp = TP.axis_of(mesh)
    data_stagings = [st for st in (step.gather_staging, step.scatter_staging)
                     if st is not None]
    seq_stagings = [st for st in (step.seq_gather_staging,
                                  step.seq_scatter_staging,
                                  step.norms_staging) if st is not None]
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _sync(ctx.device)
    ops.reset_launch_counts()
    sent0 = step.staging.sent
    data0 = step.staging.sent + step.staging.collective
    model0 = tp.staging.collective if tp else 0
    fsdp0 = [st.collective for st in data_stagings]
    seq0 = [st.collective for st in seq_stagings]
    for i in range(job.steps):
        batch = next(data)
        if job.label_mask is not None:
            batch["label_mask"] = job.label_mask
        t0 = time.perf_counter()
        out = step(params, opt, *extra, batch, np.int32(i))
        loss = float(out[0])                 # the step's one host sync
        res["host_ms"].append((time.perf_counter() - t0) * 1e3)
        params, opt = out[1], out[2]
        if job.compressed:
            extra = (out[3],)
        res["losses"].append(loss)
        res["gnorms"].append(float(out[-1]))
        res["digests"].append(param_digest(params))
        if "ef" in job.keep and job.compressed:
            res.setdefault("ef_steps", []).append(
                map_tree(lambda t: t.clone(), extra[0]))
    res["launches"] = dict(ops.LAUNCHES)
    n = max(job.steps, 1)
    res["sent_per_step"] = (step.staging.sent - sent0) / n
    res["data_bytes_per_step"] = (step.staging.sent + step.staging.collective
                                  - data0) / n
    res["model_bytes_per_step"] = ((tp.staging.collective if tp else 0)
                                   - model0) / n
    fsdp = [(st.collective - b0) / n for st, b0 in zip(data_stagings, fsdp0)]
    res["gather_bytes_per_step"], res["scatter_bytes_per_step"] = \
        fsdp or (0.0, 0.0)
    (res["seq_gather_bytes_per_step"], res["seq_scatter_bytes_per_step"],
     res["norms_bytes_per_step"]) = [
        (st.collective - b0) / n for st, b0 in zip(seq_stagings, seq0)] \
        or (0.0, 0.0, 0.0)
    if ctx.device.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    if job.compressed:
        ef = leaves(extra[0])
        res["ef_absmax"] = max(float(e.abs().max()) for e in ef)
        res["ef_nonzero"] = sum(int(e.count_nonzero()) for e in ef)
        res["ef_finite"] = all(bool(torch.isfinite(e).all()) for e in ef)
    if "params" in job.keep:
        res["params"] = params
    if job.against is not None:
        res["m_err"] = held_against(api, mesh, opt.m, job.against,
                                    job.param_rules)
    return res


def held_against(api, mesh, tree, path: str, rules=None) -> List[float]:
    """Each leaf of ``tree`` (this rank's blocks) against its block of the
    same leaf in the list of whole leaves saved at ``path`` (read as a
    memory map, so a rank reads little more than its blocks): the largest
    |difference| over the block's largest |value|."""
    whole = torch.load(path, mmap=True, weights_only=True)
    out = []
    for t, w, blk in zip(leaves(tree), whole,
                         S.param_blocks(api, mesh, rules=rules)):
        w = (w if blk is None else w[blk]).to(t.device)
        if w.shape != t.shape:
            raise ValueError(f"held_against: a block {tuple(t.shape)} "
                             f"against {tuple(w.shape)}")
        out.append(float((t - w).abs().max())
                   / max(float(w.abs().max()), 1e-30))
    return out


def train_each(ctx: RankContext, jobs: Sequence[TrainJob]) -> List[dict]:
    """``train`` for each job in turn, in one set of ranks."""
    return [train(ctx, job) for job in jobs]
