"""Trust domains: the TPU-scale analogue of the paper's enclave devices.

A TrustDomain is a mesh segment (a pod, or a slice of one) with a trust bit,
an effective throughput derate (confidential-compute overhead), and a sealing
key. The Resource Manager mirrors the paper's orchestration component: it
registers/removes domains dynamically and exports a ``ResourceGraph`` for the
placement solver.

A copy of ``repro/enclave/domain.py`` with its imports pointed at
``repro_torch``. The pod profiles the managers register are the reference
planner's model inputs (``core/cost_model.py``), kept so that the port
plans the placement the reference plans; they describe no measured card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.cost_model import (DeviceProfile, LinkProfile,
                                         TPU_POD, TPU_POD_TRUSTED, DCN_LINK)
from repro_torch.core.planner import (BoundedCache, CostTables,
                                      ExhaustiveSolver, PlacementSpec,
                                      ResourceGraph, SolveResult, get_solver,
                                      solve as planner_solve)


@dataclasses.dataclass
class TrustDomain:
    name: str
    trusted: bool
    num_chips: int
    pod_index: int                      # mesh coordinate along the pod axis
    device: DeviceProfile
    sealing_key: int = 0                # derived at attestation time
    healthy: bool = True
    last_heartbeat: float = 0.0
    base_device: Optional[DeviceProfile] = None   # pre-derate profile

    def __post_init__(self):
        if self.base_device is None:
            self.base_device = self.device

    def derive_key(self, session_nonce: bytes) -> int:
        h = hashlib.sha256(self.name.encode() + session_nonce).digest()
        self.sealing_key = int.from_bytes(h[:4], "little")
        return self.sealing_key

    # -- telemetry-driven throughput derating ------------------------------
    @property
    def derate_factor(self) -> float:
        """Cumulative derate applied so far (1.0 = at base profile)."""
        return self.device.flops_per_s / self.base_device.flops_per_s

    def derate(self, factor: float, floor: float = 0.05) -> float:
        """Fold an observed slowdown into the profile, multiplicatively but
        floored: repeated straggler observations converge to ``floor`` x the
        base profile instead of compounding ``flops_per_s`` toward zero."""
        f = max(floor, self.derate_factor * min(1.0, factor))
        self.device = dataclasses.replace(
            self.base_device, flops_per_s=self.base_device.flops_per_s * f,
            mem_bw=self.base_device.mem_bw * f)
        return f

    def reset_derate(self) -> None:
        self.device = self.base_device


class ResourceManager:
    """Registry of trust domains (paper: 'Resource Manager' in Fig. 2)."""

    def __init__(self, planner_cache_entries: int = 64):
        self._domains: Dict[str, TrustDomain] = {}
        self._links: Dict[Tuple[str, str], LinkProfile] = {}
        # per-device cost tables survive domain failures (see CostTables);
        # LRU-bounded because every derate keys a fresh table
        self._planner_cache: BoundedCache = BoundedCache(planner_cache_entries)
        self._last_plan_args: Optional[dict] = None
        self.last_plan: Optional[SolveResult] = None
        self.last_spec: Optional[PlacementSpec] = None

    # -- registration ------------------------------------------------------
    def register(self, domain: TrustDomain,
                 links: Optional[Dict[str, LinkProfile]] = None) -> None:
        self._domains[domain.name] = domain
        domain.last_heartbeat = time.monotonic()
        for peer, link in (links or {}).items():
            self._links[(domain.name, peer)] = link
            self._links[(peer, domain.name)] = link

    def remove(self, name: str) -> None:
        self._domains.pop(name, None)

    def domains(self) -> List[TrustDomain]:
        return list(self._domains.values())

    def get(self, name: str) -> TrustDomain:
        return self._domains[name]

    # -- health ------------------------------------------------------------
    def heartbeat(self, name: str) -> None:
        d = self._domains.get(name)
        if d:
            d.last_heartbeat = time.monotonic()
            d.healthy = True

    def mark_unhealthy(self, name: str) -> None:
        if name in self._domains:
            self._domains[name].healthy = False

    def healthy_domains(self) -> List[TrustDomain]:
        return [d for d in self._domains.values() if d.healthy]

    def derate(self, name: str, factor: float, floor: float = 0.05) -> float:
        """Telemetry hook: fold an observed slowdown of ``name`` into its
        device profile (bounded — see TrustDomain.derate). Returns the new
        cumulative derate factor."""
        return self._domains[name].derate(factor, floor=floor)

    # -- solver view -------------------------------------------------------
    def resource_graph(self, default_link: LinkProfile = DCN_LINK
                       ) -> ResourceGraph:
        devices = {d.name: d.device for d in self.healthy_domains()}
        return ResourceGraph(devices, dict(self._links), default_link)

    # -- planning (paper Fig. 2: Resource Manager drives the partitioner) --
    def plan(self, profiles: Sequence, *, n: int, delta: float,
             solver: str = "dp", space: str = "segment",
             pipelined: bool = True,
             max_trusted: Optional[int] = None,
             input_similarity: float = 1.0,
             default_link: LinkProfile = DCN_LINK,
             min_stages: Optional[int] = None,
             max_segments: Optional[int] = None) -> PlacementSpec:
        """Solve placement over the currently healthy domains; returns the
        chosen ``PlacementSpec`` (the runtime's consumption format — segment
        list with devices and trust domains). The full ``SolveResult`` with
        predicted stage times stays on ``self.last_plan``.

        ``space`` defaults to the segment search space (any device order,
        interleaved trust domains); pass ``space="prefix"`` for the legacy
        trusted-prefix tree. Per-device cost tables are cached on the
        manager, so repeated plans (and failure-driven re-plans over a
        shrunk graph) only pay for the search, not re-profiling. The plain
        exhaustive oracles evaluate per-layer and never read the tables, so
        none are built for them.
        """
        graph = self.resource_graph(default_link)
        sv = get_solver(solver, space)
        tables = None
        if not isinstance(sv, ExhaustiveSolver) or sv.use_tables:
            tables = CostTables(profiles, graph, input_similarity,
                                cache=self._planner_cache)
        res = planner_solve(profiles, graph, n=n, delta=delta, solver=sv,
                            pipelined=pipelined, max_trusted=max_trusted,
                            input_similarity=input_similarity, tables=tables,
                            min_stages=min_stages, max_segments=max_segments)
        self._last_plan_args = dict(
            profiles=profiles, n=n, delta=delta, solver=solver, space=space,
            pipelined=pipelined, max_trusted=max_trusted,
            input_similarity=input_similarity, default_link=default_link,
            min_stages=min_stages, max_segments=max_segments)
        self.last_plan = res
        self.last_spec = PlacementSpec.from_placement(res.best.placement,
                                                      graph)
        return self.last_spec

    def replan_on_failure(self, failed: Union[str, Iterable[str]],
                          **overrides) -> PlacementSpec:
        """Mark domain(s) unhealthy and incrementally re-solve with the
        arguments of the last ``plan()`` (overridable per call). The failed
        domains drop out of the resource graph entirely, so exclusion works
        wherever the device sat in the chain — mid-chain segments are
        re-placed, not just a trailing suffix."""
        if self._last_plan_args is None and \
                not {"profiles", "n", "delta"} <= overrides.keys():
            raise RuntimeError("replan_on_failure before any plan() "
                               "(or pass profiles, n and delta)")
        names = [failed] if isinstance(failed, str) else list(failed)
        for name in names:
            self.mark_unhealthy(name)
        args = dict(self._last_plan_args or {})
        args.update(overrides)
        profiles = args.pop("profiles")
        return self.plan(profiles, **args)


def default_two_pod_manager() -> ResourceManager:
    """The production dry-run topology: pod0 trusted (confidential-compute
    derate), pod1 untrusted full-rate — mirroring TEE1/E2 in the paper."""
    rm = ResourceManager()
    rm.register(TrustDomain("pod0", True, 256, 0, TPU_POD_TRUSTED))
    rm.register(TrustDomain("pod1", False, 256, 1, TPU_POD))
    return rm


def two_enclave_manager() -> ResourceManager:
    """Both pods trusted — the paper's 2-TEE configuration at TPU scale."""
    rm = ResourceManager()
    rm.register(TrustDomain("pod0", True, 256, 0, TPU_POD_TRUSTED))
    rm.register(TrustDomain("pod1", True, 256, 1,
                            dataclasses.replace(TPU_POD_TRUSTED, name="tpu-pod-cc2")))
    return rm


def sandwich_manager(num_untrusted: int = 2) -> ResourceManager:
    """One confidential-compute pod (derated) plus ``num_untrusted``
    full-rate untrusted pods — the topology whose optimal placement is
    non-prefix: the trusted segment pipelines with *multiple* untrusted
    segments, which the legacy trusted-prefix space (single untrusted
    suffix) cannot express."""
    rm = ResourceManager()
    rm.register(TrustDomain("pod0", True, 256, 0, TPU_POD_TRUSTED))
    for i in range(num_untrusted):
        rm.register(TrustDomain(
            f"pod{i + 1}", False, 256, i + 1,
            dataclasses.replace(TPU_POD, name=f"tpu-pod-{i + 1}")))
    return rm
