"""KV-cache state management for continuous-batching serving.
Counterpart of ``repro/serving/kvcache.py``.

Two layers:

1. ``insert_prefix`` copies a batch-1 prefill cache into one *slot* of the
   ragged decode cache, in place (the reference donates the cache to a
   jitted update).  Every non-index leaf has the layer stack first and the
   batch at axis 1; ``index`` leaves hold the per-slot valid length.

2. ``PagedKVCache`` — a paged cache substrate (block pool + block tables),
   vLLM's PagedAttention memory manager.  Pages remove the contiguous
   max_len reservation per slot: device memory is allocated in fixed-size
   blocks and sequences map to scattered blocks via a table.  ``gather``
   linearizes a sequence's pages for the decode-attention kernel; the
   host-side ``BlockAllocator`` does alloc/free bookkeeping.  The pools are
   written in place (the reference returns updated copies); ``append`` still
   returns the cache, so ``cache = cache.append(...)`` reads as there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple, Union

import torch

from ..device import resolve_device
from ..obs import get_telemetry
from ..tree import tree_leaves

Params = Dict[str, Any]

__all__ = ["insert_prefix", "live_kv_bytes", "BlockAllocator", "PagedKVCache",
           "paged_decode_attention"]


def live_kv_bytes(cache: Any) -> int:
    """Bytes held by a live KV-cache tree or ``PagedKVCache`` (works on
    ``meta`` tensors too)."""
    if isinstance(cache, PagedKVCache):
        cache = [cache.pool_k, cache.pool_v]
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(cache)))


def insert_prefix(decode_cache: Params, prefix_cache: Params, slot: int, length: int) -> Params:
    """Copy a batch-1 prefill cache into ``slot`` of the ragged decode cache.

    ``length`` is the TRUE prompt length (excluding right-padding); the
    per-slot index is set to it, so padded-prefill KV beyond the prompt is
    masked out by the ragged decode mask and overwritten by later tokens.
    Updates ``decode_cache`` in place and returns it, inside a
    ``kvcache.insert`` span.
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

    tel = get_telemetry()
    with tel.tracer.span("kvcache.insert") as sp:
        if tel.enabled:
            sp.set(slot=slot, length=length)
        ins(None, decode_cache, prefix_cache)
    return decode_cache


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------
class BlockAllocator:
    """Host-side free-list allocator over a fixed pool of cache blocks."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def allocate(self, seq_id: int, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged cache exhausted: want {n} blocks, {len(self._free)} free"
            )
        got = [self._free.pop() for _ in range(n)]
        self.tables.setdefault(seq_id, []).extend(got)
        return got

    def free(self, seq_id: int) -> None:
        self._free.extend(reversed(self.tables.pop(seq_id, [])))

    def table(self, seq_id: int) -> List[int]:
        return self.tables.get(seq_id, [])


Index = Union[int, torch.Tensor]


@dataclasses.dataclass
class PagedKVCache:
    """Block-pooled K/V storage for one attention layer group.

    pool_k/pool_v: (n_blocks, block_size, n_kv_heads, head_dim).
    A sequence of length L owns ceil(L / block_size) blocks; ``block_table``
    (max_blocks_per_seq,) integer rows map logical block i -> pool block id.
    """

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    block_size: int

    @classmethod
    def create(
        cls,
        n_blocks: int,
        block_size: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ) -> "PagedKVCache":
        dev = resolve_device(device)
        shape = (n_blocks, block_size, n_kv_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), block_size)

    def _index(self, idx: Index) -> torch.Tensor:
        return torch.as_tensor(idx, device=self.pool_k.device).long()

    # -- device ops (in place) ---------------------------------------------
    def append(self, block_id: Index, offset: Index,
               k: torch.Tensor, v: torch.Tensor) -> "PagedKVCache":
        """Write one token's (n_kv_heads, head_dim) K/V at (block, offset)."""
        b, o = self._index(block_id), self._index(offset)
        self.pool_k[b, o] = k.to(self.pool_k.dtype)
        self.pool_v[b, o] = v.to(self.pool_v.dtype)
        return self

    def append_batch(self, block_ids: Index, offsets: Index,
                     k: torch.Tensor, v: torch.Tensor) -> "PagedKVCache":
        """Batched one-token append: block_ids/offsets (B,), k/v (B, Hkv, D)."""
        return self.append(block_ids, offsets, k, v)

    def gather(self, block_table: Index) -> Tuple[torch.Tensor, torch.Tensor]:
        """Linearize pages: (max_blocks,) table -> (max_blocks*bs, Hkv, D).

        Unused table entries should point at a zero block; the caller masks
        by true length, so stale contents there are never attended to.
        """
        t = self._index(block_table)
        k, v = self.pool_k[t], self.pool_v[t]  # (nb, bs, H, D), contiguous
        nb, bs, h, d = k.shape
        return k.reshape(nb * bs, h, d), v.reshape(nb * bs, h, d)

    def gather_batch(self, block_tables: Index) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, max_blocks) tables -> (B, max_blocks*bs, Hkv, D), contiguous."""
        t = self._index(block_tables)
        k, v = self.pool_k[t], self.pool_v[t]  # (B, nb, bs, H, D)
        b, nb, bs, h, d = k.shape
        return k.reshape(b, nb * bs, h, d), v.reshape(b, nb * bs, h, d)


def paged_decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    cache: PagedKVCache,
    block_tables: Index,  # (B, max_blocks) integer
    lengths: Index,  # (B,) true sequence lengths
) -> torch.Tensor:
    """Decode attention over paged KV: gather pages, mask by true length.
    On a CUDA tensor that is the split-K decode kernel."""
    from ..kernels import ops

    k, v = cache.gather_batch(block_tables)
    return ops.decode_attention(q, k, v, lengths)
