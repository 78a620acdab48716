"""Serving substrate of the port: the unified paged engine, its page
allocator and sampling."""

from .engine import EngineConfig, EngineMetrics, Request, ServeEngine
from .paging import PageAllocator, pages_for
from .sampling import SamplingConfig, sample, sample_slots

__all__ = ["EngineConfig", "EngineMetrics", "Request", "ServeEngine",
           "PageAllocator", "pages_for", "SamplingConfig", "sample",
           "sample_slots"]
