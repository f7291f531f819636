"""Serving: the continuous-batching engine of one model replica, and the
placement-integrated cluster of replicas.

    kvcache — ragged decode-state insertion
    engine  — slot engine (prefill / insert / ragged decode)
    cluster — ClusterServer: MIG-sized replicas placed, compacted,
              reconfigured and served through attached engines
"""
from .cluster import ClusterServer, NoReplicaError, PlanExecutionError, StepPolicy  # noqa: F401
from .engine import Completion, Engine, EngineConfig, Request  # noqa: F401
from .kvcache import insert_prefix, live_kv_bytes  # noqa: F401

__all__ = ["ClusterServer", "Completion", "Engine", "EngineConfig", "NoReplicaError",
           "PlanExecutionError", "Request", "StepPolicy", "insert_prefix", "live_kv_bytes"]
