"""Serving: the continuous-batching engine of one model replica.

    kvcache — ragged decode-state insertion
    engine  — slot engine (prefill / insert / ragged decode)
"""
from .engine import Completion, Engine, EngineConfig, Request  # noqa: F401
from .kvcache import insert_prefix, live_kv_bytes  # noqa: F401

__all__ = ["Completion", "Engine", "EngineConfig", "Request", "insert_prefix", "live_kv_bytes"]
