"""Serving substrate of the port: the continuous-batching engine, its page
allocator, the radix-tree prefix cache, the disaggregated prefill/decode
cluster with page-granular KV migration, speculative decoding, beam search,
the trace-replay workload generator and sampling."""

from .beam import BeamSearcher
from .cluster import (ClusterMetrics, DisaggCluster, DisaggClusterConfig,
                      KvMigrationChannel, MigrationLink,
                      pool_split_from_plan)
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
           "ClusterMetrics", "DisaggCluster", "DisaggClusterConfig",
           "KvMigrationChannel", "MigrationLink", "pool_split_from_plan",
           "BeamSearcher",
           "PageAllocator", "pages_for", "PrefixCache", "PrefixCacheStats",
           "SamplingConfig", "sample", "sample_slots",
           "PackedSpeculator", "SpecDecodeStats", "SpeculativeDecoder",
           "rejection_accept",
           "TraceConfig", "TraceRequest", "ReplaySummary", "generate_trace",
           "replay", "smoke_config", "trace_from_json", "trace_to_json"]
