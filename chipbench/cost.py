"""A frozen copy of the kernel work counts (``repro_torch.kernels.cost``)
at the time the benchmark was defined: the operations a launch does and its
compulsory HBM bytes (each input read once, each output written once), from
its shapes.  The rooflines read these, so a change to the program's own
copy cannot move the yardstick; ``tests/test_chipbench_costs.py`` holds the
two equal at the cells' shapes.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence

__all__ = ["Work", "attention_pairs", "flash_attention", "decode_attention"]

_INT32 = 4

class Work(NamedTuple):
    flops: int
    bytes: int


def _nbytes(t) -> int:
    return math.prod(t.shape) * t.dtype.itemsize


@functools.lru_cache(maxsize=4096)
def attention_pairs(sq: int, sk: int, causal: bool, sliding_window: Optional[int]) -> int:
    """Visible (query, key) pairs per head: query i sits at key position
    i + Sk - Sq (the ends aligned); causal keeps keys at or before it, the
    window keeps keys after it less the window.  Plain Python: no tensor op
    is made, so a dispatch mode around the caller sees nothing of it."""
    total = 0
    for i in range(sq):
        pos = i + sk - sq
        hi = min(pos, sk - 1) if causal else sk - 1
        lo = max(pos - sliding_window + 1, 0) if sliding_window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_attention(q, k, v, causal: bool = True, sliding_window: Optional[int] = None) -> Work:
    """q (B,Sq,Hq,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv): 2 B Hq pairs (D + Dv)
    operations; q, k, v read and the output (B,Sq,Hq,Dv) written."""
    b, sq, hq, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    pairs = attention_pairs(sq, sk, bool(causal), sliding_window)
    out = b * sq * hq * dv * q.dtype.itemsize
    return Work(2 * b * hq * pairs * (d + dv), _nbytes(q) + _nbytes(k) + _nbytes(v) + out)


def _rows(b: int, smax: int, lengths: Optional[Sequence[int]]) -> int:
    """Cache rows a decode reads: each slot's length clamped to Smax (a
    ring's length runs past it); the whole cache without lengths."""
    if lengths is None:
        return b * smax
    return sum(min(max(int(n), 0), smax) for n in lengths)


def decode_attention(q, k, v, lengths: Optional[Sequence[int]] = None) -> Work:
    """q (B,1,Hq,D) against k (B,Smax,Hkv,D), v (B,Smax,Hkv,Dv):
    2 Hq rows (D + Dv) operations; the K/V rows up to each length, q, the
    output and the int32 lengths."""
    b, _, hq, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rows = _rows(b, smax, lengths)
    kv = rows * hkv * (d * k.dtype.itemsize + dv * v.dtype.itemsize)
    return Work(2 * hq * rows * (d + dv), kv + _nbytes(q) + b * hq * dv * q.dtype.itemsize
                + b * _INT32)
