"""Serving: the SmartConf-governed continuous-batching engine on paged KV,
open-loop traffic on a virtual clock, fault injection, and the replica
router."""

from .engine import (Admission, Request, RejectReason, SLOSpec, ServeEngine,
                     ServeOptions, TICK_STATS_KEYS)
from .kv_cache import DenseKVLease, KVBlockPool, kv_bytes_per_token
from .paging import KVLease, PagedKVAllocator
from .traffic import (OpenLoopDriver, TickCostModel, TierSpec, TraceConfig,
                      TraceEvent, VirtualClock, as_requests, concat_traces,
                      synthesize_trace)
from .chaos import ChaosMonkey, ChaosSpec
from .router import ReplicaRouter

__all__ = ["Admission", "Request", "RejectReason", "SLOSpec", "ServeEngine",
           "ServeOptions", "TICK_STATS_KEYS",
           "DenseKVLease", "KVBlockPool", "KVLease", "PagedKVAllocator",
           "kv_bytes_per_token",
           "OpenLoopDriver", "TickCostModel", "TierSpec", "TraceConfig",
           "TraceEvent", "VirtualClock", "as_requests", "concat_traces",
           "synthesize_trace",
           "ChaosMonkey", "ChaosSpec",
           "ReplicaRouter"]
