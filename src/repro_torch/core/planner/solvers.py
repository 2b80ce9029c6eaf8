"""Planner layer 2 — candidate generation behind a ``Solver`` protocol.

Two search **spaces**, each with an exhaustive oracle plus DP/beam:

**Prefix space** (the paper's Fig. 7 tree — contiguous trusted prefix stages
in device order, optional single untrusted suffix):

* ``ExhaustiveSolver`` — literal tree enumeration with per-layer cost
  evaluation. O(M^R · |U|) candidates, O(M) each. Kept verbatim as the
  correctness oracle; every other solver is property-tested against it.
* ``DPSolver`` — optimal interval DP. State = (trusted stages used, layers
  covered) → Pareto frontier of (closed total, closed bottleneck, open-stage
  time); the open component exists because a stage's seal cost depends on
  whether its successor is trusted, which is only known at the next
  transition. Dominance pruning is safe because the t_chunk objective
  (Σ + (n-1)·max) is monotone in all three components. O(R·M²·|frontier|)
  with O(1) stage costs from ``CostTables`` — orders of magnitude faster
  than exhaustive at LM depth (benchmarks/solver_scaling.py).
* ``BeamSolver`` — the same recurrence with each frontier truncated to
  ``width`` states by optimistic completion cost. Not guaranteed optimal.

**Segment space** (the ``PlacementSpec`` generalization — any contiguous
layer range on any device in any order, trusted/untrusted segments
interleaving freely, C1 only pins the *first* segment to a TEE):

* ``SegmentExhaustiveSolver`` — enumerates every (cut set, ordered device
  selection) pair; the oracle for the segment space. O(C(M-1,k-1)·P(D,k)).
* ``SegmentDPSolver`` — DP over the segment frontier keyed by
  ``(device-set, last device, boundary)``: the used-device set is needed
  because devices cannot repeat, the last device prices the outgoing
  link/seal. Exponential in device count (fine for pod-scale D), polynomial
  in depth — the practical solver for LM stacks over many devices.
* ``SegmentBeamSolver`` — same recurrence, per-key frontier truncated.

The prefix solvers remain as a fast special case behind the same ``Solver``
protocol: the prefix space is a strict subset of the segment space, so
``segment-*`` results are never worse. ``solve(..., solver="segment-dp")``
(or ``space="segment"``) is the front door; ``core.placement.solve`` remains
as a thin shim with the original signature and semantics.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import (Iterable, List, Optional, Protocol, Sequence, Tuple,
                    Union, runtime_checkable)

from .evaluation import Evaluation, Placement, SolveResult, Stage, evaluate
from .profiling import CostTables, LayerProfile, ResourceGraph


@dataclasses.dataclass
class PlacementProblem:
    """One solver invocation: workload, topology, objective.

    min_stages: require at least this many stages (serving: the pipelined
    mesh has a fixed pod count, so the engine asks for a placement using
    every pod even when a shorter placement would score better).
    max_segments: cap on the segment count in the segment space (defaults
    to the device count; prefix solvers ignore it)."""
    profiles: Sequence[LayerProfile]
    graph: ResourceGraph
    n: int
    delta: float
    max_trusted: Optional[int] = None
    pipelined: bool = True
    input_similarity: float = 1.0
    tables: Optional[CostTables] = None
    min_stages: Optional[int] = None
    max_segments: Optional[int] = None

    def trusted(self) -> List[str]:
        t = self.graph.trusted()
        return t[:self.max_trusted] if self.max_trusted is not None else t

    def untrusted(self) -> List[str]:
        return self.graph.untrusted()

    def get_tables(self) -> CostTables:
        if self.tables is None:
            self.tables = CostTables(self.profiles, self.graph,
                                     self.input_similarity)
        return self.tables

    def objective(self, ev: Evaluation) -> float:
        return ev.t_chunk if self.pipelined else ev.t_frame


@runtime_checkable
class Solver(Protocol):
    name: str

    def solve(self, problem: PlacementProblem) -> SolveResult: ...


class InfeasibleError(ValueError):
    pass


def _no_feasible() -> InfeasibleError:
    return InfeasibleError(
        "no feasible placement (privacy threshold too strict)")


# ---------------------------------------------------------------------------
# Placement-tree enumeration (Fig. 7)
# ---------------------------------------------------------------------------
def enumerate_placements(num_layers: int, graph: ResourceGraph,
                         max_trusted: Optional[int] = None,
                         ) -> Iterable[Placement]:
    """All tree paths: 1..R trusted prefix stages (contiguous, in device
    order) optionally followed by one untrusted suffix device."""
    M = num_layers
    trusted = graph.trusted()
    if max_trusted is not None:
        trusted = trusted[:max_trusted]
    untrusted = graph.untrusted()
    R = len(trusted)

    for r in range(1, R + 1):
        # boundaries 0 < b1 < ... < b_{r-1} < M split the prefix among the
        # r trusted devices; b_r in (b_{r-1}, M] ends the trusted prefix.
        for cuts in itertools.combinations(range(1, M), r - 1):
            starts = (0,) + cuts
            for last_end in range(starts[-1] + 1, M + 1):
                ends = cuts + (last_end,)
                stages = tuple(Stage(d, s, e) for d, s, e
                               in zip(trusted, starts, ends))
                if last_end == M:
                    yield Placement(stages)
                else:
                    for u in untrusted:
                        yield Placement(stages + (Stage(u, last_end, M),))


def enumerate_segment_placements(num_layers: int, graph: ResourceGraph,
                                 max_segments: Optional[int] = None,
                                 max_trusted: Optional[int] = None,
                                 ) -> Iterable[Placement]:
    """The segment space: every contiguous partition of [0, M) assigned to
    an ordered selection of *distinct* devices, first device trusted (C1).
    Trusted and untrusted segments interleave freely — the PlacementSpec
    generalization of the Fig. 7 prefix tree. ``max_trusted`` keeps the
    prefix solvers' semantics: only the first ``max_trusted`` trusted
    devices (graph order) are eligible."""
    M = num_layers
    trusted = graph.trusted()
    if max_trusted is not None:
        trusted = trusted[:max_trusted]
    devices = trusted + graph.untrusted()
    K = len(devices) if max_segments is None \
        else min(max_segments, len(devices))
    K = min(K, M)
    for k in range(1, K + 1):
        for cuts in itertools.combinations(range(1, M), k - 1):
            bounds = (0,) + cuts + (M,)
            for perm in itertools.permutations(devices, k):
                if not graph.devices[perm[0]].trusted:
                    continue
                yield Placement(tuple(Stage(d, s, e) for d, s, e
                                      in zip(perm, bounds, bounds[1:])))


@dataclasses.dataclass
class ExhaustiveSolver:
    """Enumerate, evaluate, argmin subject to C2 — the correctness oracle.

    ``use_tables=True`` swaps the O(M) per-candidate evaluation for O(1)
    CostTables queries (same numbers modulo float association).
    """
    name: str = "exhaustive"
    use_tables: bool = False

    def _enumerate(self, problem: PlacementProblem) -> Iterable[Placement]:
        return enumerate_placements(len(problem.profiles), problem.graph,
                                    problem.max_trusted)

    def solve(self, problem: PlacementProblem) -> SolveResult:
        t0 = time.perf_counter()
        tables = problem.get_tables() if self.use_tables else None
        evals: List[Evaluation] = []
        best: Optional[Evaluation] = None
        best_key: Optional[float] = None
        n_feasible = 0
        min_stages = problem.min_stages or 0
        for p in self._enumerate(problem):
            ev = evaluate(p, problem.profiles, problem.graph, problem.n,
                          problem.delta,
                          input_similarity=problem.input_similarity,
                          tables=tables)
            evals.append(ev)
            if not ev.feasible or len(p.stages) < min_stages:
                continue
            n_feasible += 1
            key = problem.objective(ev)
            if best_key is None or key < best_key:
                best, best_key = ev, key
        if best is None:
            raise _no_feasible()
        return SolveResult(best, evals, len(evals), n_feasible,
                           len(evals) - n_feasible, self.name,
                           time.perf_counter() - t0)


@dataclasses.dataclass
class SegmentExhaustiveSolver(ExhaustiveSolver):
    """The exhaustive oracle over the segment space (PlacementSpec search):
    any device order, interleaved domains, distinct devices."""
    name: str = "segment-exhaustive"

    def _enumerate(self, problem: PlacementProblem) -> Iterable[Placement]:
        return enumerate_segment_placements(
            len(problem.profiles), problem.graph, problem.max_segments,
            problem.max_trusted)


# ---------------------------------------------------------------------------
# Interval DP / beam over Pareto frontiers
# ---------------------------------------------------------------------------
# A partial state covers layers [0, b) with r trusted stages, the last of
# which is still "open" (its outgoing seal cost depends on the successor):
#   (closed_total, closed_bottleneck, open_time, bounds)
# bounds = (0, b1, ..., b) reconstructs the placement.
_State = Tuple[float, float, float, Tuple[int, ...]]


def _dominates(a: _State, b: _State) -> bool:
    return a[0] <= b[0] and a[1] <= b[1] and a[2] <= b[2]


def _pareto(states: List[_State]) -> Tuple[List[_State], int]:
    """Keep the non-dominated states; returns (kept, n_pruned)."""
    states.sort(key=lambda s: (s[0], s[1], s[2]))
    kept: List[_State] = []
    for s in states:
        if not any(_dominates(k, s) for k in kept):
            kept.append(s)
    return kept, len(states) - len(kept)


@dataclasses.dataclass
class _FrontierSolver:
    """Shared recurrence for DPSolver (unbounded frontier) and BeamSolver
    (frontier truncated to ``width`` by optimistic completion cost)."""
    name: str = "dp"
    width: Optional[int] = None

    def solve(self, problem: PlacementProblem) -> SolveResult:
        t0 = time.perf_counter()
        tables = problem.get_tables()
        M = len(problem.profiles)
        trusted = problem.trusted()
        untrusted = problem.untrusted()
        if not trusted or M == 0:   # C1: processing must start in a TEE
            raise _no_feasible()
        n, delta = problem.n, problem.delta
        pipelined = problem.pipelined
        n_pruned = 0
        n_candidates = 0
        n_feasible = 0
        truncated = False
        best_key: Optional[float] = None
        best_bounds: Optional[Tuple] = None   # (bounds, suffix_device|None)

        def complete_key(ct: float, cb: float, open_t: float) -> float:
            total = ct + open_t
            return total + (n - 1) * max(cb, open_t) if pipelined else total

        def optimistic(s: _State) -> float:
            return complete_key(s[0], s[1], s[2])

        min_stages = problem.min_stages or 0

        def finalize(states: List[_State], r: int) -> None:
            """Close every state either at b == M or with an untrusted
            suffix over [b, M)."""
            nonlocal best_key, best_bounds, n_candidates, n_feasible, n_pruned
            last_dev = trusted[r - 1]
            for ct, cb, open_t, bounds in states:
                b = bounds[-1]
                if b == M:
                    if r < min_stages:
                        continue        # too few stages; extensions may pass
                    n_candidates += 1
                    n_feasible += 1
                    key = complete_key(ct, cb, open_t)
                    if best_key is None or key < best_key:
                        best_key, best_bounds = key, (bounds, None)
                    continue
                if r + 1 < min_stages:
                    continue            # even with a suffix, too few stages
                if tables.max_sim(b, M) >= delta:
                    n_pruned += len(untrusted)   # privacy-infeasible suffixes
                    continue
                suffix_t = {u: tables.stage_time(u, b, M) for u in untrusted}
                for u in untrusted:
                    n_candidates += 1
                    n_feasible += 1
                    link = tables.link_time(last_dev, u, b)
                    total = ct + open_t + link + suffix_t[u]
                    key = (total + (n - 1) * max(cb, open_t, link, suffix_t[u])
                           if pipelined else total)
                    if best_key is None or key < best_key:
                        best_key, best_bounds = key, (bounds, u)

        # r = 1: trusted[0] owns [0, b)
        frontier = {b: [(0.0, 0.0, tables.stage_time(trusted[0], 0, b),
                         (0, b))] for b in range(1, M + 1)}
        for r in range(1, len(trusted) + 1):
            for states in frontier.values():
                finalize(states, r)
            if r == len(trusted):
                break
            nxt_dev, prev_dev = trusted[r], trusted[r - 1]
            nxt: dict = {}
            for b, states in frontier.items():
                if b >= M:
                    continue
                # boundary costs and candidate stage times depend only on
                # (b, e), not on the state — compute once per cell
                seal_out = tables.seal(prev_dev, b)
                link = tables.link_time(prev_dev, nxt_dev, b)
                unseal = tables.seal(nxt_dev, b)
                opens = [unseal + tables.stage_time(nxt_dev, b, e)
                         for e in range(b + 1, M + 1)]
                for ct, cb, open_t, bounds in states:
                    # branch-and-bound: the optimistic completion key only
                    # grows along any extension, so states already worse than
                    # the incumbent (set by finalize) cannot win
                    if (best_key is not None
                            and complete_key(ct, cb, open_t) >= best_key):
                        n_pruned += 1
                        continue
                    # close the open stage: it seals for its trusted successor
                    closed = open_t + seal_out
                    ct2 = ct + closed + link
                    cb2 = max(cb, closed, link)
                    for i, open2 in enumerate(opens):
                        e = b + 1 + i
                        nxt.setdefault(e, []).append(
                            (ct2, cb2, open2, bounds + (e,)))
            frontier = {}
            for e, states in nxt.items():
                kept, pruned = _pareto(states)
                n_pruned += pruned
                if self.width is not None and len(kept) > self.width:
                    kept.sort(key=optimistic)
                    n_pruned += len(kept) - self.width
                    kept = kept[:self.width]
                    truncated = True
                frontier[e] = kept

        if best_bounds is None:
            raise _no_feasible()
        bounds, suffix = best_bounds
        stages = tuple(Stage(d, s, e) for d, s, e
                       in zip(trusted, bounds, bounds[1:]))
        if suffix is not None:
            stages += (Stage(suffix, bounds[-1], M),)
        # re-evaluate the winner with the oracle path for exact parity
        best = evaluate(Placement(stages), problem.profiles, problem.graph,
                        n, delta, input_similarity=problem.input_similarity)
        return SolveResult(best, [best], n_candidates, n_feasible, n_pruned,
                           self.name, time.perf_counter() - t0,
                           truncated=truncated)


@dataclasses.dataclass
class DPSolver(_FrontierSolver):
    """Optimal contiguous partition via interval DP with Pareto pruning."""
    name: str = "dp"
    width: Optional[int] = None


@dataclasses.dataclass
class BeamSolver(_FrontierSolver):
    """DP recurrence with frontiers truncated to ``width`` — approximate,
    for very deep stacks × many domains."""
    name: str = "beam"
    width: Optional[int] = 8


# ---------------------------------------------------------------------------
# Segment-space DP / beam: frontier keyed by (device-set, last device, b)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _SegmentFrontierSolver:
    """Shared recurrence for SegmentDPSolver (exact) and SegmentBeamSolver
    (per-key frontier truncated to ``width``).

    A partial state covers layers [0, b) with an *open* segment on ``last``;
    the key carries the used-device set (devices cannot repeat) and ``last``
    (it prices the outgoing link and, against a trusted successor, the seal).
    Values are ``(closed_total, closed_bottleneck, open_time, segs)`` with
    ``segs`` a tuple of (device, end) pairs for reconstruction. Dominance
    pruning and incumbent branch-and-bound are safe for the same reason as
    the prefix DP: the chunk objective is monotone in every component along
    any extension."""
    name: str = "segment-dp"
    width: Optional[int] = None

    def solve(self, problem: PlacementProblem) -> SolveResult:
        t0 = time.perf_counter()
        tables = problem.get_tables()
        M = len(problem.profiles)
        graph = problem.graph
        trusted = problem.trusted()         # honors max_trusted
        devices = trusted + problem.untrusted()
        if not trusted or M == 0:   # C1: processing must start in a TEE
            raise _no_feasible()
        n, delta, pipelined = problem.n, problem.delta, problem.pipelined
        K = len(devices) if problem.max_segments is None \
            else min(problem.max_segments, len(devices))
        K = min(K, M)
        min_stages = problem.min_stages or 0
        n_candidates = n_feasible = n_pruned = 0
        truncated = False
        best_key: Optional[float] = None
        best_segs: Optional[Tuple] = None

        def complete_key(ct: float, cb: float, open_t: float) -> float:
            total = ct + open_t
            return total + (n - 1) * max(cb, open_t) if pipelined else total

        def feasible_ends(dname: str, b: int) -> List[int]:
            """Segment [b, e) ends admissible on ``dname``; C2 bounds an
            untrusted segment's reach (max_sim is monotone in e)."""
            if graph.devices[dname].trusted:
                return list(range(b + 1, M + 1))
            ends = []
            for e in range(b + 1, M + 1):
                if tables.max_sim(b, e) >= delta:
                    break
                ends.append(e)
            return ends

        # r = 1: a single trusted segment [0, b)
        frontier: dict = {}
        for d in trusted:
            for b in range(1, M + 1):
                frontier.setdefault((frozenset((d,)), d, b), []).append(
                    (0.0, 0.0, tables.stage_time(d, 0, b), ((d, b),)))

        for r in range(1, K + 1):
            for (used, last, b), states in frontier.items():
                if b != M or r < min_stages:
                    continue
                for ct, cb, open_t, segs in states:
                    n_candidates += 1
                    n_feasible += 1
                    key = complete_key(ct, cb, open_t)
                    if best_key is None or key < best_key:
                        best_key, best_segs = key, segs
            if r == K:
                break
            nxt: dict = {}
            for (used, last, b), states in frontier.items():
                if b >= M:
                    continue
                last_trusted = graph.devices[last].trusted
                for d in devices:
                    if d in used:
                        continue
                    both = last_trusted and graph.devices[d].trusted
                    seal_out = tables.seal(last, b) if both else 0.0
                    unseal = tables.seal(d, b) if both else 0.0
                    link = tables.link_time(last, d, b)
                    ends = feasible_ends(d, b)
                    if not ends:
                        n_pruned += 1   # C2 leaves no admissible segment
                        continue
                    opens = [(e, unseal + tables.stage_time(d, b, e))
                             for e in ends]
                    used2 = used | {d}
                    for ct, cb, open_t, segs in states:
                        if (best_key is not None
                                and complete_key(ct, cb, open_t) >= best_key):
                            n_pruned += 1
                            continue
                        closed = open_t + seal_out
                        ct2 = ct + closed + link
                        cb2 = max(cb, closed, link)
                        for e, open2 in opens:
                            nxt.setdefault((used2, d, e), []).append(
                                (ct2, cb2, open2, segs + ((d, e),)))
            frontier = {}
            for key, states in nxt.items():
                kept, pruned = _pareto(states)
                n_pruned += pruned
                if self.width is not None and len(kept) > self.width:
                    kept.sort(key=lambda s: complete_key(s[0], s[1], s[2]))
                    n_pruned += len(kept) - self.width
                    kept = kept[:self.width]
                    truncated = True
                frontier[key] = kept

        if best_segs is None:
            raise _no_feasible()
        bounds = (0,) + tuple(e for _, e in best_segs)
        stages = tuple(Stage(d, s, e) for (d, _), s, e
                       in zip(best_segs, bounds, bounds[1:]))
        # re-evaluate the winner with the oracle path for exact parity
        best = evaluate(Placement(stages), problem.profiles, graph, n, delta,
                        input_similarity=problem.input_similarity)
        return SolveResult(best, [best], n_candidates, n_feasible, n_pruned,
                           self.name, time.perf_counter() - t0,
                           truncated=truncated)


@dataclasses.dataclass
class SegmentDPSolver(_SegmentFrontierSolver):
    """Optimal over the segment space via (device-set, last, boundary) DP."""
    name: str = "segment-dp"
    width: Optional[int] = None


@dataclasses.dataclass
class SegmentBeamSolver(_SegmentFrontierSolver):
    """Segment DP with per-key frontiers truncated to ``width``."""
    name: str = "segment-beam"
    width: Optional[int] = 8


_SOLVERS = {"exhaustive": ExhaustiveSolver, "dp": DPSolver, "beam": BeamSolver,
            "segment-exhaustive": SegmentExhaustiveSolver,
            "segment-dp": SegmentDPSolver,
            "segment-beam": SegmentBeamSolver}


def get_solver(spec: Union[str, Solver, None],
               space: Optional[str] = None) -> Solver:
    """Resolve a solver. ``space="segment"`` maps the short names
    ("exhaustive"/"dp"/"beam", or None) onto their segment-space variants;
    ``space="prefix"`` (or None) leaves them as the prefix solvers."""
    if space not in (None, "prefix", "segment"):
        raise ValueError(f"unknown space {space!r}; "
                         f"expected 'prefix' or 'segment'")
    if spec is None:
        spec = "exhaustive"
    if isinstance(spec, str):
        if space == "segment" and not spec.startswith("segment-"):
            spec = "segment-" + spec
        try:
            return _SOLVERS[spec]()
        except KeyError:
            raise ValueError(f"unknown solver {spec!r}; "
                             f"expected one of {sorted(_SOLVERS)}")
    return spec


def solve(profiles: Sequence[LayerProfile], graph: ResourceGraph, *,
          n: int, delta: float, max_trusted: Optional[int] = None,
          pipelined: bool = True, input_similarity: float = 1.0,
          solver: Union[str, Solver, None] = None,
          tables: Optional[CostTables] = None,
          min_stages: Optional[int] = None,
          space: Optional[str] = None,
          max_segments: Optional[int] = None) -> SolveResult:
    """Plan a placement. ``solver``: "exhaustive" (default; the oracle),
    "dp" (optimal, fast), "beam" (approximate, fastest), their "segment-*"
    variants (the PlacementSpec search space), or a Solver. ``space`` remaps
    the short names: ``space="segment"`` turns "dp" into "segment-dp"."""
    problem = PlacementProblem(profiles, graph, n, delta, max_trusted,
                               pipelined, input_similarity, tables,
                               min_stages, max_segments)
    return get_solver(solver, space).solve(problem)
