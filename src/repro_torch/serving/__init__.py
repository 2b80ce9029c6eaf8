"""Serving layer of the port: scheduler, greedy sampler, stage telemetry,
the paged engine and its local and pipelined backends."""
from .engine import (EngineConfig, PagedLocalBackend, PagedPipelinedBackend,
                     ServingEngine)
from .scheduler import PagePool, Request, SlotScheduler, SwapManifest
from .telemetry import StageTelemetry

__all__ = ["EngineConfig", "PagePool", "PagedLocalBackend",
           "PagedPipelinedBackend", "Request", "ServingEngine",
           "SlotScheduler", "StageTelemetry", "SwapManifest"]
