"""Serving layer of the port: scheduler, token sampler (greedy, or seeded
temperature / top-k sampling keyed as the reference's), stage telemetry,
the paged engine and its local and pipelined backends, and disaggregated
prefill/decode (``disagg``: a prefill-role engine seals each prompt's KV
pages into a ``TransferManifest`` that a decode-role engine unseals into
its own pool, routed by ``DisaggOrchestrator``, roles placed by
``plan_disagg_roles``), and the chaos fault plane (``faults``:
``FaultConfig``, ``FaultPlane``) whose injected faults the engine's
recovery ladder absorbs. The names the reference exports are here, less
its XLA compile monitor (``AotFn``, ``CompileMonitor``, ``MONITOR``):
the port's ``GraphFn`` captures CUDA graphs instead."""
from .aot import AotRegistry, CompileStall
from .disagg import (DisaggOrchestrator, PrefillEngine, RoleCandidate,
                     RolePlan, build_disagg, plan_disagg_roles)
from .engine import (EngineConfig, EngineEvent, LocalDecodeBackend,
                     PagedLocalBackend, PagedPipelinedBackend,
                     PipelinedDecodeBackend, ServingEngine,
                     pipelined_backend_available)
from .faults import FaultConfig, FaultPlane
from .sampling import TokenSampler
from .scheduler import (HANDOFF, PagePool, Request, SlotScheduler,
                        SwapManifest, TransferManifest)
from .telemetry import StageTelemetry

__all__ = ["AotRegistry", "CompileStall", "DisaggOrchestrator",
           "EngineConfig", "EngineEvent", "FaultConfig", "FaultPlane",
           "HANDOFF", "LocalDecodeBackend", "PagePool", "PagedLocalBackend",
           "PagedPipelinedBackend", "PipelinedDecodeBackend", "PrefillEngine",
           "Request", "RoleCandidate", "RolePlan", "ServingEngine",
           "SlotScheduler", "StageTelemetry", "SwapManifest",
           "TokenSampler", "TransferManifest", "build_disagg",
           "pipelined_backend_available", "plan_disagg_roles"]
