"""Layered placement planner (DESIGN.md §Planner, §Placement spec).

Four decoupled layers:

1. **profiling** — ``LayerProfile``/``ResourceGraph`` plus ``CostTables``
   (prefix-sum / range-max structure making stage cost, EPC working set and
   seal/transfer times O(1) per candidate);
2. **placement spec** — ``PlacementSpec``: an ordered list of
   ``Segment(device, start, end, domain)`` records; trusted and untrusted
   segments interleave freely, every cut carries an explicit
   transfer+seal+leakage cost (``CutCost``). The legacy boundaries-list
   surface goes through ``spec_from_boundaries`` (deprecation shim);
3. **candidate generation** — the ``Solver`` protocol. Prefix-space solvers
   (``ExhaustiveSolver``/``DPSolver``/``BeamSolver``, the paper's Fig. 7
   tree) remain as a fast special case; segment-space solvers
   (``SegmentExhaustiveSolver`` oracle, ``SegmentDPSolver`` over the
   (device-set, last, boundary) frontier, ``SegmentBeamSolver``) search the
   full PlacementSpec space;
4. **re-planning** — ``ResourceManager.plan()/replan_on_failure()``
   (enclave.domain) re-solves over the surviving domains, reusing cached
   tables, and returns the ``PlacementSpec`` the pipelined runtime consumes.

A copy of ``repro/core/planner`` (host code, no device work); the port
keeps no ``core/placement.py`` shim.
"""
from .evaluation import (Evaluation, Placement, SolveResult, Stage, evaluate)
from .profiling import (BoundedCache, CostTables, DeviceTable, LayerProfile,
                        ResourceGraph, profiles_from_arch, profiles_from_cnn,
                        stage_exec_direct)
from .solvers import (BeamSolver, DPSolver, ExhaustiveSolver,
                      InfeasibleError, PlacementProblem, SegmentBeamSolver,
                      SegmentDPSolver, SegmentExhaustiveSolver, Solver,
                      enumerate_placements, enumerate_segment_placements,
                      get_solver, solve)
from .spec import (TRUSTED, UNTRUSTED, CutCost, PlacementSpec, Segment,
                   spec_from_boundaries)

__all__ = [
    "BeamSolver", "BoundedCache", "CostTables", "CutCost", "DPSolver",
    "DeviceTable", "Evaluation",
    "ExhaustiveSolver", "InfeasibleError", "LayerProfile", "Placement",
    "PlacementProblem", "PlacementSpec", "ResourceGraph", "Segment",
    "SegmentBeamSolver", "SegmentDPSolver", "SegmentExhaustiveSolver",
    "SolveResult", "Solver", "Stage", "TRUSTED", "UNTRUSTED",
    "enumerate_placements", "enumerate_segment_placements", "evaluate",
    "get_solver", "profiles_from_arch", "profiles_from_cnn", "solve",
    "spec_from_boundaries", "stage_exec_direct",
]
