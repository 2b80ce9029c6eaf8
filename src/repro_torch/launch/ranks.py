"""Ranks of one host, and the messages between them.

The reference's ``pod`` and ``data`` axes are devices XLA lays out in one
process. Here each device of a mesh is a process, a rank of a
``torch.distributed`` process group:

    outs = spawn(body, 4, backend="gloo", device="cpu", args=(...,))

starts ``body(ctx, *args)`` once per rank (``ctx`` a ``RankContext``) in
processes made by ``torch.multiprocessing`` with the ``spawn`` method (a
card does not survive a fork), joined over a ``FileStore`` in a temporary
directory: no address and no network. ``body`` must be a top-level
function of an importable module, since each rank imports it by name.
What each rank returns comes back to the parent, tensors moved to the
CPU, as a list in rank order. If a rank raises, the others get a short
grace (``GRACE_S``) to finish or fail on their own, then the rest are
stopped, and the parent raises a ``RuntimeError`` holding the traceback
of every rank that failed by itself; the process group's timeout
(``TIMEOUT_S``) turns a rank stuck on a message its peer never sends
into an error instead of a hang.

The caller names the backend, ``gloo`` or ``nccl``; nothing picks one.
NCCL places one rank per card: more ranks than visible cards raises
before any process starts. Gloo moves host memory only, so the helpers
below (``send``, ``recv``, ``exchange``, ``all_reduce`` (a sum or a
max), ``broadcast``, ``all_gather``, ``reduce_scatter``) stage a card's
tensor through a pinned host buffer of the ``Staging`` the caller owns,
then copy it to the card: a sealed payload crosses host memory between
two enclaves, as the paper's boundaries do. Under NCCL, or with tensors
already on the CPU, they pass tensors as they are.

An engine whose stages are ranks runs the same host logic on every rank,
so what that logic reads must agree: ``share`` gives every rank one
rank's host numbers (a clock reading, a verdict vector), and
``transfer`` posts a set of point-to-point
messages of sizes both sides know (a stage's KV rows on a live re-plan, a
swap payload's columns) and completes them together.

No message may be posted or waited on inside a function under graph
management (``serving/aot.py``): a CUDA graph replays device work only,
so a message captured in one would never be sent again, and a rank
waiting in a capture stalls its peers. ``no_messages(name)`` marks such a
function's run; every helper below raises in it, naming the function.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

TIMEOUT_S = 120.0
# after the first rank fails, how long the others may take to end on their
# own (a rank slower to start still reports its own fault) before the
# rest are stopped
GRACE_S = 5.0
BACKENDS = ("gloo", "nccl")

# the managed functions running on this process, innermost last
_QUIET: List[str] = []


@contextlib.contextmanager
def no_messages(name: str):
    """Run a managed function ``name``: a message inside raises."""
    _QUIET.append(name)
    try:
        yield
    finally:
        _QUIET.pop()


def _may_message(what: str) -> None:
    if _QUIET:
        raise RuntimeError(
            f"{what} inside the managed function {_QUIET[-1]!r}: a CUDA "
            f"graph replays device work only, so messages are posted and "
            f"waited on between managed calls")


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What ``spawn`` tells a rank body: its rank, the world size, the
    backend of the default process group and the rank's device."""

    rank: int
    world: int
    backend: str
    device: torch.device


def check_backend(backend: str, world: int, device) -> torch.device:
    """Refuse a backend that cannot run ``world`` ranks on ``device``, by
    name, before any process starts; returns the resolved device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend='nccl' runs on cards, not {dev}")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"backend='nccl' with {world} ranks but {cards} visible "
                f"card(s): NCCL places one rank per card and refuses two "
                f"on one; run several ranks on one card with "
                f"backend='gloo' (ROADMAP item 10c)")
    return dev


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, tuple):                       # a NamedTuple
        return type(tree)(*(_to_cpu(v) for v in tree))
    return tree


def _entry(rank: int, fn: Callable, world: int, backend: str, device: str,
           tmp: str, args: tuple, timeout_s: float) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    else:
        # ranks share the host's cores: one thread each
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(RankContext(rank, world, backend, dev), *args)
        path = os.path.join(tmp, f"rank{rank}.pt")
        torch.save(_to_cpu(out), path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        # the parent reports every rank's traceback, not only the first
        # one its join happens to see
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str, device,
          args: Sequence[Any] = (), timeout_s: float = TIMEOUT_S
          ) -> List[Any]:
    """Run ``fn(ctx, *args)`` on ``world`` ranks (see the module's
    docstring); returns their results in rank order. A card's ranks all
    run on ``device`` (``cuda`` is ``cuda:0``). Build the CUDA kernels
    first (``kernels.build.build_all``), or every rank runs nvcc."""
    if world < 1:
        raise ValueError(f"spawn: world {world}")
    dev = check_backend(backend, world, device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        procs = mp.start_processes(
            _entry, args=(fn, world, backend, str(dev), tmp, tuple(args),
                          float(timeout_s)),
            nprocs=world, join=False, start_method="spawn").processes
        stopped = _wait_ranks(procs)
        failed = [r for r, p in enumerate(procs)
                  if p.exitcode != 0 and r not in stopped]
        if failed or stopped:
            errs = {r: open(os.path.join(tmp, f"rank{r}.err")).read()
                    for r in range(world)
                    if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
            raise RuntimeError(
                f"spawn: {fn.__module__}.{fn.__qualname__} failed on ranks "
                f"{sorted(set(errs) | set(failed))} of {world}"
                + (f" (ranks {stopped} stopped after a {GRACE_S:g} s "
                   f"grace)" if stopped else "") + "\n"
                + "\n".join(f"--- rank {r} ---\n{tb}"
                             for r, tb in sorted(errs.items())))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _wait_ranks(procs) -> List[int]:
    """Wait for every rank's process to end. After the first one ends
    with an error, the others get ``GRACE_S`` to end on their own; those
    still running then are stopped, and returned (their ranks)."""
    from multiprocessing.connection import wait
    alive = {p.sentinel: r for r, p in enumerate(procs)}
    deadline = None
    while alive:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            break
        for s in wait(list(alive), left):
            p = procs[alive.pop(s)]
            p.join()
            if p.exitcode != 0 and deadline is None:
                deadline = time.monotonic() + GRACE_S
    stopped = sorted(alive.values())
    for r in stopped:
        procs[r].terminate()
    for r in stopped:
        procs[r].join(GRACE_S)
        if procs[r].is_alive():
            procs[r].kill()
            procs[r].join()
    return stopped


# ---------------------------------------------------------------------------
# Messages, staged through the host under gloo
# ---------------------------------------------------------------------------
def group_ranks(group) -> List[int]:
    """The global ranks of ``group`` in its own order (the default group
    for None)."""
    return dist.get_process_group_ranks(group or dist.group.WORLD)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


class Staging:
    """Pinned host buffers for one rank's messages under gloo, reused by
    tag: a buffer is written again only after the message that used it
    was waited for (the caller's tags say which messages may be in flight
    together). Also counts the bytes this rank sent point to point
    (``sent``) and the bytes it put into collectives (``collective``:
    what it passed to ``all_reduce``, ``broadcast``, ``all_gather`` and
    ``reduce_scatter``)."""

    def __init__(self):
        self._bufs: Dict[Tuple, torch.Tensor] = {}
        self.sent = 0
        self.collective = 0

    def host(self, tag, like: torch.Tensor) -> torch.Tensor:
        key = (tag, tuple(like.shape), like.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf

    def _wire(self, t: torch.Tensor, group, tag) -> torch.Tensor:
        """What goes to the transport for ``t``: a pinned copy for a card's
        tensor under gloo, else ``t`` itself (contiguous)."""
        if t.is_cuda and _gloo(group):
            buf = self.host(tag, t)
            buf.copy_(t)                # waits for the stream that wrote t
            return buf
        return t.contiguous()

    def _landing(self, like: torch.Tensor, group, tag) -> torch.Tensor:
        if like.is_cuda and _gloo(group):
            return self.host(tag, like)
        return torch.empty_like(like, memory_format=torch.contiguous_format)


class Pending:
    """Messages in flight; ``wait()`` completes them and returns what was
    received, each on the device of the tensor that described it."""

    def __init__(self, works, outs, keep=()):
        self._works = works
        self._outs = outs
        self._keep = keep             # what the transport reads until wait

    def wait(self) -> List[torch.Tensor]:
        _may_message("a message's wait")
        for w in self._works:
            w.wait()
        self._keep = ()
        return [buf.to(dev, non_blocking=False) if buf.device != dev
                else buf for buf, dev in self._outs]


def send(staging: Staging, tensors: Sequence[torch.Tensor], dst: int,
         group=None, tag="send") -> Pending:
    """Post ``tensors`` to global rank ``dst`` (in order); wait on the
    result before the buffers of ``tag`` are used again."""
    _may_message("send")
    works, wires = [], []
    for i, t in enumerate(tensors):
        wire = staging._wire(t, group, (tag, i))
        works.append(dist.isend(wire, dst, group=group))
        wires.append(wire)
        staging.sent += t.numel() * t.element_size()
    return Pending(works, [], wires)


def recv(staging: Staging, likes: Sequence[torch.Tensor], src: int,
         group=None, tag="recv") -> Pending:
    """Post receives from global rank ``src`` into tensors shaped and typed
    as ``likes`` (in order), returned by ``wait()`` on their devices."""
    _may_message("recv")
    works, outs = [], []
    for i, like in enumerate(likes):
        buf = staging._landing(like, group, (tag, i))
        works.append(dist.irecv(buf, src, group=group))
        outs.append((buf, like.device))
    return Pending(works, outs)


def exchange(staging: Staging, tensors: Sequence[torch.Tensor], peer: int,
             group=None, tag="exchange") -> List[torch.Tensor]:
    """Swap ``tensors`` with global rank ``peer``, which calls this with
    tensors of the same shapes: both sends and both receives are posted
    before either side waits, so neither order can deadlock."""
    incoming = recv(staging, tensors, peer, group, (tag, "in"))
    outgoing = send(staging, tensors, peer, group, (tag, "out"))
    got = incoming.wait()
    outgoing.wait()
    return got


def all_reduce(staging: Staging, t: torch.Tensor, group=None,
               tag="all_reduce", op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: elementwise max) of ``t`` over ``group``,
    written into ``t`` and returned; the same bits on every rank (the
    backend reduces each element once and hands the result to all)."""
    _may_message("all_reduce")
    if dist.get_world_size(group) == 1:
        return t
    staging.collective += t.numel() * t.element_size()
    wire = staging._wire(t, group, tag)
    dist.all_reduce(wire, op={"sum": dist.ReduceOp.SUM,
                              "max": dist.ReduceOp.MAX}[op], group=group)
    if wire is not t:
        t.copy_(wire)
    return t


def broadcast(staging: Staging, t: torch.Tensor, src: int, group=None,
              tag="broadcast") -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of ``group``, written into
    ``t`` and returned."""
    _may_message("broadcast")
    if dist.get_world_size(group) == 1:
        return t
    staging.collective += t.numel() * t.element_size()
    wire = staging._wire(t, group, tag)
    dist.broadcast(wire, src, group=group)
    if wire is not t:
        t.copy_(wire)
    return t


def all_gather(staging: Staging, t: torch.Tensor, group=None,
               tag="all_gather") -> torch.Tensor:
    """Every rank's ``t`` stacked in the group's order: [group size,
    *t.shape] on ``t``'s device."""
    _may_message("all_gather")
    n = dist.get_world_size(group)
    if n == 1:
        return t[None]
    staging.collective += t.numel() * t.element_size()
    wire = staging._wire(t, group, (tag, "in"))
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    land = staging._landing(out, group, (tag, "out"))
    dist.all_gather(list(land.unbind(0)), wire, group=group)
    if land is not out:
        out.copy_(land)
    return out


def reduce_scatter(staging: Staging, t: torch.Tensor, group=None,
                   tag="reduce_scatter", dim: int = 0) -> torch.Tensor:
    """The f32 sum of ``t`` over ``group``, cut into the group's size
    blocks along ``dim``: this rank's block, in the group's order (rank
    i of the group the i-th), a new contiguous f32 tensor on ``t``'s
    device; the same bits as the sum's block on every rank. ``t`` (each
    rank's of one shape, ``dim`` divisible by the group's size) is not
    written; its bytes count as this rank's input."""
    _may_message("reduce_scatter")
    n = dist.get_world_size(group)
    x = t.float().movedim(dim, 0)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks")
    if n == 1:
        return x.movedim(0, dim).clone(
            memory_format=torch.contiguous_format)
    x = x.contiguous()
    staging.collective += x.numel() * x.element_size()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=t.device)
    wire = staging._wire(x, group, (tag, "in"))
    land = staging._landing(out, group, (tag, "out"))
    dist.reduce_scatter_tensor(land, wire, group=group)
    if land is not out:
        out.copy_(land)
    return out.movedim(0, dim).contiguous()


def peer_of(group) -> int:
    """The other global rank of a two-rank group."""
    ranks = group_ranks(group)
    me = dist.get_rank()
    if len(ranks) != 2 or me not in ranks:
        raise ValueError(f"peer_of: rank {me} in group {ranks}")
    return ranks[1 - ranks.index(me)]


# ---------------------------------------------------------------------------
# Host values every rank must agree on, and sets of messages
# ---------------------------------------------------------------------------
def message_device(group) -> torch.device:
    """Where a host value travels: the rank's card under NCCL (which moves
    only device memory), else the host."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def share(values: Sequence[float], src: int, group=None) -> List[float]:
    """Global rank ``src``'s ``values`` (floats, exact as float64) on every
    rank of ``group``; each rank passes a sequence of the same length."""
    _may_message("share")
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=message_device(group))
    if dist.get_world_size(group) > 1:
        dist.broadcast(t, src, group=group)
    return t.tolist()


def transfer(staging: Staging, outgoing: Sequence[Tuple[int, Sequence]],
             incoming: Sequence[Tuple[int, Sequence]], group=None,
             tag="transfer") -> List[List[torch.Tensor]]:
    """Post every receive of ``incoming`` (``(src, likes)`` each, the
    tensors' shapes and types known here) and every send of ``outgoing``
    (``(dst, tensors)``), then complete them all; returns what each
    receive got, in order. Two ranks must list their messages to each
    other in the same order (the transport matches them in order);
    posting all before waiting on any means no order of the pairs can
    deadlock."""
    recvs = [recv(staging, likes, src, group, (tag, "in", i))
             for i, (src, likes) in enumerate(incoming)]
    sends = [send(staging, tensors, dst, group, (tag, "out", i))
             for i, (dst, tensors) in enumerate(outgoing)]
    got = [r.wait() for r in recvs]
    for p in sends:
        p.wait()
    return got
