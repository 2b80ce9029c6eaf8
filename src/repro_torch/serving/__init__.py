"""Serving layer of the port: scheduler, greedy sampler, paged engine."""
from .engine import EngineConfig, PagedLocalBackend, ServingEngine
from .scheduler import PagePool, Request, SlotScheduler, SwapManifest

__all__ = ["EngineConfig", "PagePool", "PagedLocalBackend", "Request",
           "ServingEngine", "SlotScheduler", "SwapManifest"]
