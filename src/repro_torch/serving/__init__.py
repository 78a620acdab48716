"""Serving substrate of the port: the continuous-batching engine, its page
allocator, the radix-tree prefix cache, speculative decoding, the
trace-replay workload generator and sampling."""

from .engine import EngineConfig, EngineMetrics, Request, ServeEngine
from .paging import PageAllocator, pages_for
from .prefix_cache import PrefixCache, PrefixCacheStats
from .sampling import SamplingConfig, sample, sample_slots
from .speculative import (PackedSpeculator, SpecDecodeStats,
                          SpeculativeDecoder, rejection_accept)
from .workload import (ReplaySummary, TraceConfig, TraceRequest,
                       generate_trace, replay, smoke_config, trace_from_json,
                       trace_to_json)

__all__ = ["EngineConfig", "EngineMetrics", "Request", "ServeEngine",
           "PageAllocator", "pages_for", "PrefixCache", "PrefixCacheStats",
           "SamplingConfig", "sample", "sample_slots",
           "PackedSpeculator", "SpecDecodeStats", "SpeculativeDecoder",
           "rejection_accept",
           "TraceConfig", "TraceRequest", "ReplaySummary", "generate_trace",
           "replay", "smoke_config", "trace_from_json", "trace_to_json"]
