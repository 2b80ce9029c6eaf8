"""PlacementSpec — the first-class segment-graph placement description.

The paper's planner (and PR 2/3's solvers) baked in the simplest placement
shape: a contiguous *trusted prefix* in fixed device order plus at most one
untrusted tail. DistPrivacy-style many-device placement interleaves trusted
and untrusted segments freely, so the placement API is now an ordered list
of ``Segment(device, start, end, domain)`` records over a ``ResourceGraph``:

* any contiguous layer range may be assigned to any device, in any order
  (each device hosts at most one segment — a segment is a pipeline stage);
* multiple untrusted segments may interleave with enclave segments;
* every cut between segments carries an explicit cost record (``CutCost``):
  link-transfer time from the graph edge, seal/unseal time when both sides
  are trusted, and a leakage price (``core.privacy.cut_exposure``) when the
  activation lands on an untrusted device.

``PlacementSpec`` is what ``ResourceManager.plan()`` returns and what
``PipelinedDecoder.from_spec`` / ``ServingEngine`` consume. The legacy
``boundaries``-list surface goes through :func:`spec_from_boundaries` /
:meth:`PlacementSpec.boundaries`, which assert round-trip equivalence and
warn with ``DeprecationWarning``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

from ..cost_model import seal_time, transmit_time
from .evaluation import Placement, Stage
from .profiling import LayerProfile, ResourceGraph

TRUSTED = "trusted"
UNTRUSTED = "untrusted"


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous layer range on one device.

    ``domain`` records the trust domain the segment executes in; it must
    match the device's trust bit in the graph (checked by ``validate``)."""
    device: str
    start: int                 # inclusive layer index
    end: int                   # exclusive
    domain: str = TRUSTED      # TRUSTED | UNTRUSTED

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def trusted(self) -> bool:
        return self.domain == TRUSTED


@dataclasses.dataclass(frozen=True)
class CutCost:
    """The explicit cost of one segment boundary (the activation crossing
    ``boundary`` is the output of layer ``boundary - 1``)."""
    boundary: int
    src: str
    dst: str
    out_bytes: float
    transfer_s: float          # link transfer (graph edge bandwidth+latency)
    seal_s: float              # seal + unseal when both sides are trusted
    trust_crossing: bool       # domain changes across this cut
    leakage: float             # privacy.cut_exposure price (0 inside TEEs)


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """An ordered, contiguous, device-distinct segment placement."""
    segments: Tuple[Segment, ...]

    # -- shape ---------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return self.segments[-1].end if self.segments else 0

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def devices(self) -> Tuple[str, ...]:
        return tuple(s.device for s in self.segments)

    def domains(self) -> Tuple[str, ...]:
        return tuple(s.domain for s in self.segments)

    def device_of(self, layer: int) -> str:
        for s in self.segments:
            if s.start <= layer < s.end:
                return s.device
        raise IndexError(layer)

    def stage_sizes(self) -> Tuple[int, ...]:
        """Per-segment layer counts — feed to PipelinedDecoder.from_spec."""
        return tuple(s.size for s in self.segments)

    def describe(self) -> str:
        tag = {TRUSTED: "T", UNTRUSTED: "U"}
        return " | ".join(
            f"L{s.start}..L{s.end - 1}@{s.device}[{tag[s.domain]}]"
            for s in self.segments)

    # -- validation ----------------------------------------------------------
    def validate(self, num_layers: Optional[int] = None,
                 graph: Optional[ResourceGraph] = None) -> "PlacementSpec":
        """Contiguity, full cover, distinct devices, C1, domain/graph
        agreement. Returns self so construction sites can chain."""
        assert self.segments, "empty placement"
        assert self.segments[0].start == 0, self.segments[0]
        for a, b in zip(self.segments, self.segments[1:]):
            assert a.end == b.start, f"gap/overlap at {a} -> {b}"
        for s in self.segments:
            assert s.end > s.start, f"empty segment {s}"
            assert s.domain in (TRUSTED, UNTRUSTED), s.domain
        devs = self.devices()
        assert len(set(devs)) == len(devs), f"device reused: {devs}"
        assert self.segments[0].domain == TRUSTED, \
            "C1: processing must start in a trusted domain"
        if num_layers is not None:
            assert self.segments[-1].end == num_layers, \
                (self.segments[-1].end, num_layers)
        if graph is not None:
            for s in self.segments:
                dev = graph.devices[s.device]      # KeyError = unknown device
                assert dev.trusted == s.trusted, \
                    f"{s.device}: spec says {s.domain}, graph disagrees"
        return self

    def is_prefix(self, graph: ResourceGraph) -> bool:
        """Whether this placement is expressible in the legacy trusted-prefix
        space: trusted segments first, in the graph's trusted-device order,
        followed by at most one untrusted segment."""
        doms = [s.trusted for s in self.segments]
        n_trusted = sum(doms)
        if doms != [True] * n_trusted + [False] * (len(doms) - n_trusted):
            return False
        if len(doms) - n_trusted > 1:
            return False
        trusted_order = graph.trusted()
        return list(self.devices()[:n_trusted]) == trusted_order[:n_trusted]

    # -- cut costs -----------------------------------------------------------
    def cut_costs(self, profiles: Sequence[LayerProfile],
                  graph: ResourceGraph) -> Tuple[CutCost, ...]:
        """Explicit per-boundary costs: link transfer, seal/unseal, leakage."""
        from ..privacy import cut_exposure
        out: List[CutCost] = []
        for a, b in zip(self.segments, self.segments[1:]):
            cut = a.end                  # >= 1: segments are non-empty
            nbytes = profiles[cut - 1].out_bytes
            src_d, dst_d = graph.devices[a.device], graph.devices[b.device]
            seal_s = 0.0
            if src_d.trusted and dst_d.trusted:
                seal_s = seal_time(nbytes, src_d) + seal_time(nbytes, dst_d)
            sim = profiles[cut - 1].similarity
            leak = 0.0 if dst_d.trusted else cut_exposure(sim, nbytes)
            out.append(CutCost(
                boundary=cut, src=a.device, dst=b.device, out_bytes=nbytes,
                transfer_s=transmit_time(nbytes, graph.link(a.device,
                                                            b.device)),
                seal_s=seal_s,
                trust_crossing=src_d.trusted != dst_d.trusted,
                leakage=leak))
        return tuple(out)

    def total_leakage(self, profiles: Sequence[LayerProfile],
                      graph: ResourceGraph) -> float:
        return sum(c.leakage for c in self.cut_costs(profiles, graph))

    # -- conversions ---------------------------------------------------------
    def to_placement(self) -> Placement:
        return Placement(tuple(Stage(s.device, s.start, s.end)
                               for s in self.segments))

    @classmethod
    def from_placement(cls, placement: Placement,
                       graph: ResourceGraph) -> "PlacementSpec":
        segs = tuple(Segment(
            s.device, s.start, s.end,
            TRUSTED if graph.devices[s.device].trusted else UNTRUSTED)
            for s in placement.stages)
        return cls(segs).validate(graph=graph)

    # -- legacy boundaries-list surface (deprecated) -------------------------
    def boundaries(self) -> List[int]:
        """The legacy interior-cut list ``[b1, ..., b_{k-1}]``. Deprecated:
        a bare cut list cannot express device order or domain interleaving —
        consume ``segments`` / ``stage_sizes()`` instead."""
        warnings.warn(
            "PlacementSpec.boundaries() is a legacy surface; use "
            ".segments / .stage_sizes()", DeprecationWarning, stacklevel=2)
        return [s.end for s in self.segments[:-1]]


def spec_from_boundaries(boundaries: Sequence[int], devices: Sequence[str],
                         num_layers: int,
                         graph: ResourceGraph) -> PlacementSpec:
    """Deprecation shim for old ``boundaries``-list call sites.

    Builds a PlacementSpec from the legacy (cut list, device order) pair and
    asserts round-trip equivalence — the spec must reproduce exactly the
    boundaries it was built from."""
    warnings.warn(
        "boundaries-list placements are deprecated; construct a "
        "PlacementSpec (planner.spec) instead", DeprecationWarning,
        stacklevel=2)
    cuts = [int(b) for b in boundaries]
    assert len(devices) == len(cuts) + 1, (devices, cuts)
    bounds = [0] + cuts + [num_layers]
    segs = tuple(Segment(
        d, s, e, TRUSTED if graph.devices[d].trusted else UNTRUSTED)
        for d, s, e in zip(devices, bounds, bounds[1:]))
    spec = PlacementSpec(segs).validate(num_layers, graph)
    got = [s.end for s in spec.segments[:-1]]
    assert got == cuts, f"shim round-trip mismatch: {got} != {cuts}"
    return spec
