"""Rank bodies for ``launch.ranks.spawn``: the pipelined decoder with one
stage per pod rank, the serving engine with one stage per pod rank, and
the train step (plain or compressed) over a mesh of pod and data ranks,
each driven for a few steps from inputs the caller hands over on the CPU,
or from seeded weights drawn on the rank's device.

    outs = spawn(rank_jobs.decode, 4, backend="gloo", device="cpu",
                 args=(DecodeJob(cfg, ((2, 2), ("pod", "data")), ...),))
    outs = spawn(rank_jobs.serve, 2, backend="gloo", device="cpu",
                 args=(ServeJob(cfg, [ServeRun(EngineConfig(...),
                                               requests)]),))

Each body returns, per rank, what it computed (logits, tokens, losses,
the rank's cache or params), the kernel launches it made (``ops.LAUNCHES``
over the driven steps only), host milliseconds a step and the bytes it
messaged, so a caller can hold the ranks against one device and against
each other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

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
from repro_torch.runtime.pipeline import PipelinedDecoder
from repro_torch.serving.engine import EngineConfig, ServingEngine
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
            lg, cache = step(mine, cache, {"tokens": tok}, job.key + i)
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
    boundary) and ``ops.seal_bits`` (swaps, restages, prefill crossings)
    are wrapped, keys and counters kept as given (device tensors cloned,
    read back at ``close``, so recording adds no host sync)."""

    def __init__(self):
        self.records: List[tuple] = []
        self._raw: List[tuple] = []

    def __enter__(self):
        self._real = (ops.seal, ops.seal_bits)
        real_seal, real_bits = self._real

        def keep(v):
            return v.detach().clone() if isinstance(v, torch.Tensor) else v

        def seal(x, key, counter, *a, **kw):
            self._raw.append(("seal", keep(key), keep(counter), 0,
                              x.shape[1], x.shape[1]))
            return real_seal(x, key, counter, *a, **kw)

        def seal_bits(x, key, counter, col0=0, row_cols=None):
            self._raw.append(("seal_bits", keep(key), keep(counter),
                              int(col0), x.shape[1],
                              x.shape[1] if row_cols is None
                              else int(row_cols)))
            return real_bits(x, key, counter, col0=col0, row_cols=row_cols)

        ops.seal, ops.seal_bits = seal, seal_bits
        return self

    def __exit__(self, *exc):
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
    logits; ``topology`` names a ``launch.serve.TOPOLOGIES`` entry."""

    config: EngineConfig
    requests: Sequence[Tuple[Sequence[int], int]]
    every: int = 0
    inject: Optional[Tuple[int, float]] = None
    keep_logits: bool = False
    topology: str = "two-enclave"
    max_steps: int = 2000
    check_swaps: bool = False


@dataclasses.dataclass
class ServeJob:
    """``ServingEngine(mesh=)`` on each rank, over each of ``runs`` in
    turn. ``params`` on the CPU, or None to draw them from ``seed`` on the
    rank's device (every rank draws the same bits)."""

    cfg: ArchConfig
    runs: Sequence[ServeRun]
    dtype: torch.dtype = torch.float32
    params: Any = None
    seed: int = 0
    max_seq: int = 4096


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
    (``keep``), the stage probes run (``probes``), host ms of each
    swap-out and swap-in, the first swap-out's payload, digest, layout
    and counter, and (``check``) every swap-in's pages against the rows
    gathered at its swap-out, bit for bit (``restored`` pages; a swap-in
    whose stage layout moved since is counted in ``moved`` instead)."""

    def __init__(self, eng, keep: bool, check: bool = False):
        self.step_ms, self.step_bytes, self.logits = [], [], []
        self.swap_out_ms, self.swap_in_ms = [], []
        self.first_swap = None
        self.probes = self.restored = self.moved = 0
        be, dev = eng.backend, eng.device
        staging = getattr(be, "staging", None)
        step, sample, times = be.step, eng._sample, be.stage_times
        pending = []

        def timed_step(tokens, key):
            _sync(dev)
            pending[:] = [time.perf_counter(),
                          staging.sent if staging else 0]
            out = step(tokens, key)
            if keep:
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
            return times()

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
                                       counter=man.counter)

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
    ``moved`` (``Probe``), ``decode_steps``, ``relayouts``; and ``keys``, every (kind, key, counter, col0,
    cols, row_cols) this rank sealed under (``KeyLedger``)."""
    from repro_torch.launch.serve import TOPOLOGIES
    api, params = _model(ctx, job.cfg, job.dtype, job.params, job.seed,
                         job.max_seq)
    params = map_tree(lambda t: t.cpu(), params)
    _sync(ctx.device)
    mesh = make_mesh((ctx.world, 1), ("pod", "data"), device=ctx.device)
    out = []
    for run in job.runs:
        with KeyLedger() as ledger:
            eng = ServingEngine(api, run.config, params, device=ctx.device,
                                rm=TOPOLOGIES[run.topology](
                                    run.config.num_stages),
                                backend="pipelined", mesh=mesh)
            if run.inject:
                eng.telemetry.inject(*run.inject)
            probe = Probe(eng, run.keep_logits, run.check_swaps)
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
            "stage": be.stage, "range": be.dec.ranges[be.stage],
            "launches": launches, "step_ms": probe.step_ms,
            "step_bytes": probe.step_bytes,
            "admission_ms": list(eng.admission_ms),
            "crossings": list(be.crossings), "restages": list(be.restages),
            "relayouts": getattr(be, "relayouts", 0),
            "swap_out_ms": probe.swap_out_ms,
            "swap_in_ms": probe.swap_in_ms,
            "first_swap": probe.first_swap, "logits": probe.logits,
            "probes": probe.probes, "restored": probe.restored,
            "moved": probe.moved, "decode_steps": be.steps,
            "keys": ledger.records})
        del eng, be, probe
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
    ``label_mask`` [batch, seq] when given. ``params`` on the CPU, or None
    to draw them from ``seed`` on the rank's device."""

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
    keep_state: bool = True          # return the params and every ef


def train(ctx: RankContext, job: TrainJob) -> dict:
    """The rank's ``losses`` and ``gnorms`` a step, a ``param_digest`` of
    its params after each step, ``launches``, ``host_ms`` a step, the
    bytes it sent a step, its peak device memory (a card), the error
    feedback's largest |value| and nonzero count (compressed), and with
    ``keep_state`` the final ``params`` and the ``ef`` after every step
    (``ef_steps``)."""
    api, params = _model(ctx, job.cfg, job.dtype, job.params, job.seed,
                         job.seq)
    mesh = make_mesh(*job.mesh, device=ctx.device)
    opt = adamw.init(params)
    extra = (init_error_feedback(params),) if job.compressed else ()
    step = S.make_train_step(api, job.opt,
                             ShapeConfig("ranks", job.seq, job.batch,
                                         "train"),
                             device=ctx.device, mesh=mesh,
                             compress_pod_grads=job.compressed)
    data = SyntheticTokenStream(job.cfg.vocab_size, job.batch, job.seq,
                                structure=job.structure)
    res = {"losses": [], "gnorms": [], "digests": [], "host_ms": []}
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _sync(ctx.device)
    ops.reset_launch_counts()
    sent0 = step.staging.sent
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
        if job.keep_state and job.compressed:
            res.setdefault("ef_steps", []).append(
                map_tree(lambda t: t.clone(), extra[0]))
    res["launches"] = dict(ops.LAUNCHES)
    res["sent_per_step"] = (step.staging.sent - sent0) / max(job.steps, 1)
    if ctx.device.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    if job.compressed:
        ef = leaves(extra[0])
        res["ef_absmax"] = max(float(e.abs().max()) for e in ef)
        res["ef_nonzero"] = sum(int(e.count_nonzero()) for e in ef)
        res["ef_finite"] = all(bool(torch.isfinite(e).all()) for e in ef)
    if job.keep_state:
        res["params"] = params
    return res


def train_each(ctx: RankContext, jobs: Sequence[TrainJob]) -> List[dict]:
    """``train`` for each job in turn, in one set of ranks."""
    return [train(ctx, job) for job in jobs]
