"""Warmup as CUDA graphs: the port of ``repro/serving/aot.py``.

Under JAX a warmed serving step is one dispatch of an executable compiled
ahead of time. Eagerly, PyTorch issues every kernel of the step from the
host, about a thousand launches per decode step of full-width llama3.2-1b.
Captured once into a CUDA graph and replayed, the same step is one launch
from the host. This module is the machinery behind
``ServingEngine.warmup()``; the names are the reference's, so the engine's
``stats()`` keeps the reference's keys.

* ``_sig_of`` -- the signature that selects a graph: tree structure, each
  tensor's shape, dtype and device type, and the VALUE of each host int.
  Unlike the reference (whose Python scalars are traced), a host int here
  is baked into the captured kernels (a bucket width, a chunk offset), so
  it must select the graph; a per-call number travels as a tensor.
* ``GraphFn`` -- one function under management (the reference's
  ``AotFn``). It dispatches by device, as ``kernels/ops.py`` does:

  - on CPU tensors it only keeps the signature ledger and calls the
    function eagerly, so warmup on the CPU has the card's inventory and
    stall bookkeeping;
  - on CUDA tensors, when its registry captures, ``warm()`` runs the
    function eagerly a few times on the registry's capture stream (lazy
    state: cuBLAS workspaces, the kernels' libraries, the paged kernel's
    merge counters, the rotary table) and then captures it into a graph,
    with static input buffers that the wrapper owns and outputs in the
    registry's one memory pool. ``__call__`` copies the call's per-call
    tensors into those buffers and replays. A signature first seen in
    ``__call__`` is a stall: that call runs once eagerly on the capture
    stream (its warm-up run, and the call's own effect: a step runs
    exactly once) and is captured for every later call. A failed capture
    raises; nothing falls back.

  ``ops.LAUNCHES`` counts on the host, so a replay would not move it: each
  graph keeps the launches its capture counted (and takes them back out
  of the counts, since a capture launches nothing) and adds them on every
  replay. So that a host ledger of what was sealed sees replays too, code
  running under a capture may ``note`` tensors its graph fills at every
  replay (``capture_notes``), and ``REPLAY_HOOKS`` see each graph after
  its replay; a warm's repeated eager runs (the same call on the same
  inputs) are marked by ``repeat_run``.
* ``AotRegistry`` -- one engine's functions, its capture stream and graph
  memory pool, the stall ledger and the freeze point. ``post_freeze_compiles``
  counts the graph captures made after ``freeze()``.

There is no ``CompileMonitor``: PyTorch compiles nothing here (the
reference's monitor is a no-op on jax 0.9.0 anyway).

A managed function touches the device only: a message posted or waited
on inside one raises, naming it (``launch.ranks.no_messages``), on the
CPU as on the card. An engine whose stages are ranks manages the device
segments between its messages, and posts the messages itself.

A graph's outputs are static: the next replay of the same graph writes
them again, and since every graph of a registry shares one memory pool, so
may the replay of another graph (an output can sit where an earlier
capture kept its temporaries). A caller reads an output before its next
managed call, or clones it. A graph holds the addresses of every tensor
it touched at capture (weights, page pools, block tables): those must be
updated in place, never reallocated.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.launch.ranks import no_messages

#: eager runs on the capture stream before ``warm()`` captures
WARM_RUNS = 3

#: ``hook(graph)`` after every replay of a captured graph (``_Graph``)
REPLAY_HOOKS: List[Callable] = []
# the notes of the capture in progress; a warm's run after its first
_capture_notes: Optional[list] = None
_repeat = False


def capture_notes() -> Optional[list]:
    """The note list of the graph being captured (what is appended stays
    with the graph, ``_Graph.notes``), or None outside a capture."""
    return _capture_notes


def repeat_run() -> bool:
    """Whether a warm's second or later eager run is running: it repeats
    the first on the same inputs."""
    return _repeat


def _sig_of(args) -> Tuple:
    """Hashable call signature of ``args`` (tensors, host scalars, and
    tuples or lists of them): nested structure, then per tensor (shape,
    dtype, device type) and per host scalar (type name, value)."""
    if isinstance(args, torch.Tensor):
        return ("T", tuple(args.shape), str(args.dtype), args.device.type)
    if isinstance(args, (tuple, list)):
        return (type(args).__name__, tuple(_sig_of(a) for a in args))
    return (type(args).__name__, args)


def _shapes(sig) -> List[Any]:
    """Leaf shapes (tensors) and values (host scalars) of a signature."""
    if sig[0] == "T":
        return [list(sig[1])]
    if sig[0] in ("tuple", "list"):
        return [s for a in sig[1] for s in _shapes(a)]
    return [sig[1]]


def _leaves(tree) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [x for a in tree for x in _leaves(a)]
    return [tree]


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, a) for a in tree)
    return tree


def _on_cuda(args) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in _leaves(args))


@dataclasses.dataclass
class CompileStall:
    """A managed function called with a signature never warmed."""

    name: str
    sig: Tuple
    frozen: bool                        # True: occurred after freeze()

    def describe(self) -> str:
        return f"{self.name}{_shapes(self.sig)}"


@dataclasses.dataclass
class _Graph:
    """One captured signature: the graph, its static input buffers (the
    call's tensor leaves, in order), its static outputs and the kernel
    launches one replay makes."""

    graph: Any
    inputs: List[torch.Tensor]
    outputs: Any
    launches: Dict[str, int]
    notes: list = dataclasses.field(default_factory=list)

    def replay(self, args) -> Any:
        for buf, x in zip(self.inputs, (a for a in _leaves(args)
                                        if isinstance(a, torch.Tensor))):
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n
        for hook in REPLAY_HOOKS:
            hook(self)
        return self.outputs


class GraphFn:
    """One function under graph management (see the module docstring)."""

    def __init__(self, name: str, fn: Callable, registry: "AotRegistry"):
        self.name, self.fn = name, fn
        self.registry = registry
        # sig -> its graph, or None where the signature runs eagerly (CPU
        # tensors, or a registry that does not capture)
        self.entries: Dict[Tuple, Optional[_Graph]] = {}

    @property
    def signatures(self) -> List[Tuple]:
        return list(self.entries)

    @property
    def graphs(self) -> int:
        return sum(g is not None for g in self.entries.values())

    def _captures(self, args) -> bool:
        return self.registry.capture and _on_cuda(args)

    def warm(self, *args) -> None:
        """Enter this signature in the inventory: on the card (when the
        registry captures) run it ``WARM_RUNS`` times on the capture
        stream and capture it. The arguments must be state-neutral, since
        the warm runs execute: the engine warms with idle slots and
        drop-sentinel page vectors."""
        sig = _sig_of(args)
        if sig in self.entries:
            return
        self.entries[sig] = self._capture(args, WARM_RUNS)[0] \
            if self._captures(args) else None

    def __call__(self, *args):
        sig = _sig_of(args)
        if sig in self.entries:
            entry = self.entries[sig]
            return self._run(*args) if entry is None else entry.replay(args)
        self.registry.record_stall(self, sig)
        if not self._captures(args):
            self.entries[sig] = None
            return self._run(*args)
        self.entries[sig], out = self._capture(args, 1)
        return out

    def _run(self, *args):
        with no_messages(self.name):
            return self.fn(*args)

    def _capture(self, args, runs: int):
        """Run ``fn`` eagerly ``runs`` times on the capture stream (the
        last run's outputs are returned), then capture one call into a
        graph over static copies of ``args``."""
        global _capture_notes, _repeat
        reg = self.registry
        stream, pool = reg.capture_resources()
        static = _map_tensors(lambda t: t.clone(), args)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            try:
                for i in range(runs):
                    _repeat = i > 0
                    out = self._run(*static)
            finally:
                _repeat = False
        torch.cuda.current_stream().wait_stream(stream)
        before = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        notes: list = []
        # no cyclic garbage collection inside the capture: it could destroy
        # a dead engine's graphs, and a graph reset while a stream captures
        # invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            _capture_notes = notes
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                outputs = self._run(*static)
        finally:
            if collecting:
                gc.enable()
            _capture_notes = None
            launched = {k: ops.LAUNCHES[k] - n for k, n in before.items()}
            ops.LAUNCHES.update(before)     # a capture launches nothing
        reg.captures += 1
        inputs = [t for t in _leaves(static) if isinstance(t, torch.Tensor)]
        entry = _Graph(graph, inputs, outputs,
                       {k: n for k, n in launched.items() if n}, notes)
        return entry, out


class AotRegistry:
    """One engine's managed functions, capture stream, graph memory pool,
    stall ledger and freeze point. ``capture`` False keeps the ledger but
    runs every call eagerly (an engine without warmup)."""

    def __init__(self, capture: bool = True):
        self.capture = capture
        self.fns: Dict[str, GraphFn] = {}
        self.frozen = False
        self.stalls: List[CompileStall] = []
        self.captures = 0               # graphs captured, all time
        self._captures_at_freeze: Optional[int] = None
        self._stream = None
        self._pool = None

    def wrap(self, name: str, fn: Callable) -> GraphFn:
        f = GraphFn(name, fn, self)
        self.fns[name] = f
        return f

    def capture_resources(self):
        """(stream, pool) that every capture of this registry uses, made at
        the first capture. One pool for all graphs: their temporaries
        share memory (replays run one at a time on one stream), and the
        paged kernel's merge counters, kept per stream, are one buffer for
        every graph."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream, self._pool

    def record_stall(self, fn: GraphFn, sig: Tuple) -> None:
        self.stalls.append(CompileStall(fn.name, sig, self.frozen))

    def freeze(self) -> None:
        """Warmup done: later captures count as post-freeze compiles."""
        self.frozen = True
        self._captures_at_freeze = self.captures

    @property
    def graphs(self) -> int:
        return sum(f.graphs for f in self.fns.values())

    def drop_graphs(self) -> None:
        """Forget every signature (a rank engine whose state moved to new
        memory): each is entered again at its next call, as a stall."""
        for f in self.fns.values():
            f.entries.clear()

    @property
    def post_freeze_compiles(self) -> Optional[int]:
        """Graph captures since ``freeze()``; None when never frozen."""
        if self._captures_at_freeze is None:
            return None
        return self.captures - self._captures_at_freeze

    @property
    def post_freeze_stalls(self) -> List[CompileStall]:
        return [s for s in self.stalls if s.frozen]
