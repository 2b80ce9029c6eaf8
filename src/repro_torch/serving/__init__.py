"""Serving layer of the port: scheduler, token sampler (greedy, or seeded
temperature / top-k sampling keyed as the reference's), stage telemetry,
the paged engine and its local and pipelined backends, and disaggregated
prefill/decode (``disagg``: a prefill-role engine seals each prompt's KV
pages into a ``TransferManifest`` that a decode-role engine unseals into
its own pool, routed by ``DisaggOrchestrator``, roles placed by
``plan_disagg_roles``), and the chaos fault plane (``faults``:
``FaultConfig``, ``FaultPlane``) whose injected faults the engine's
recovery ladder absorbs."""
from .disagg import (DisaggOrchestrator, PrefillEngine, RoleCandidate,
                     RolePlan, build_disagg, plan_disagg_roles)
from .engine import (EngineConfig, PagedLocalBackend, PagedPipelinedBackend,
                     ServingEngine)
from .faults import FaultConfig, FaultPlane
from .scheduler import (HANDOFF, PagePool, Request, SlotScheduler,
                        SwapManifest, TransferManifest)
from .telemetry import StageTelemetry

__all__ = ["DisaggOrchestrator", "EngineConfig", "FaultConfig", "FaultPlane",
           "HANDOFF", "PagePool", "PagedLocalBackend",
           "PagedPipelinedBackend", "PrefillEngine",
           "Request", "RoleCandidate", "RolePlan", "ServingEngine",
           "SlotScheduler", "StageTelemetry", "SwapManifest",
           "TransferManifest", "build_disagg", "plan_disagg_roles"]
