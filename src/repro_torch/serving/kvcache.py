"""KV-cache state management for continuous-batching serving.
Counterpart of ``repro/serving/kvcache.py`` (decode-state slot insertion;
the paged cache is not ported yet).

``insert_prefix`` copies a batch-1 prefill cache into one *slot* of the
ragged decode cache, in place (the reference donates the cache to a jitted
update).  Every non-index leaf has the layer stack first and the batch at
axis 1; ``index`` leaves hold the per-slot valid length.
"""
from __future__ import annotations

from typing import Any, Dict

from ..tree import tree_leaves

Params = Dict[str, Any]

__all__ = ["insert_prefix", "live_kv_bytes"]


def live_kv_bytes(cache: Any) -> int:
    """Bytes held by a live KV-cache tree (works on ``meta`` tensors too)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(cache)))


def insert_prefix(decode_cache: Params, prefix_cache: Params, slot: int, length: int) -> Params:
    """Copy a batch-1 prefill cache into ``slot`` of the ragged decode cache.

    ``length`` is the TRUE prompt length (excluding right-padding); the
    per-slot index is set to it, so padded-prefill KV beyond the prompt is
    masked out by the ragged decode mask and overwritten by later tokens.
    Updates ``decode_cache`` in place and returns it.
    """

    def ins(key, dst, src):
        if isinstance(dst, dict):
            for k in dst:
                ins(k, dst[k], src[k])
        elif isinstance(dst, list):
            for d, s in zip(dst, src):
                ins(key, d, s)
        elif key == "index":
            dst[..., slot] = length  # dst (..., n_slots)
        else:
            dst[:, slot] = src[:, 0].to(dst.dtype)  # (stack, n_slots, ...) <- (stack, 1, ...)

    ins(None, decode_cache, prefix_cache)
    return decode_cache
