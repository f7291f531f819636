"""Serving: the continuous-batching engine of one model replica, and the
placement-integrated cluster of replicas.

    kvcache — ragged decode-state insertion, and the paged KV cache
              (block allocator, block pools, paged decode attention)
    engine  — slot engine (prefill / insert / ragged decode)
    cluster — ClusterServer: MIG-sized replicas placed, compacted,
              reconfigured and served through attached engines
"""
from .cluster import ClusterServer, NoReplicaError, PlanExecutionError, StepPolicy  # noqa: F401
from .engine import Completion, Engine, EngineConfig, Request  # noqa: F401
from .kvcache import (  # noqa: F401
    BlockAllocator, PagedKVCache, insert_prefix, live_kv_bytes, paged_decode_attention,
)

__all__ = ["BlockAllocator", "ClusterServer", "Completion", "Engine", "EngineConfig",
           "NoReplicaError", "PagedKVCache", "PlanExecutionError", "Request", "StepPolicy",
           "insert_prefix", "live_kv_bytes", "paged_decode_attention"]
