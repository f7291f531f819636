"""The work of one kernel launch, from its shapes, dtypes and arguments.

One function per kernel gives ``Work(flops, bytes)``: the operations the
launch does on its inputs and its compulsory HBM traffic (each input read
once, each output written once).  The same expressions give
``chip_smoke.py``'s ``bound_ms`` and what the static cost analysis
(``distribution/cost_analysis.py``) books for a launch on a ``meta``
tensor, so a count of a kernel's work reads the same whatever implements
it.  Nothing here times anything.

The arguments are anything with ``shape`` and ``dtype`` (tensors, real or
``meta``).  Where the work depends on the data (a decode's lengths), the
caller gives it; without it the decode prices the whole cache.

``booking(sink)`` makes ``sink(name, work)`` receive every ``book`` call
made inside it; the kernels' ``meta`` routes book their launches this way.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence

__all__ = ["Work", "attention_pairs", "flash_attention", "decode_attention",
           "decode_attention_q8", "ssd_pairs", "ssd_scan", "book", "booking", "SSD_TILE"]

#: the SSD kernel's time tile (``CHUNK`` in ssd_scan.py): its causal pairs
#: are counted within each tile
SSD_TILE = 64
_INT32 = 4

_SINKS: List[Callable[[str, "Work"], None]] = []


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


def decode_attention_q8(q, k_q, k_s, v_q, v_s, lengths: Optional[Sequence[int]] = None) -> Work:
    """The decode over an int8 cache: as ``decode_attention``, with each
    row's int8 K/V and its two f32 scales."""
    b, _, hq, d = q.shape
    smax, hkv = k_q.shape[1], k_q.shape[2]
    dv = v_q.shape[-1]
    rows = _rows(b, smax, lengths)
    kv = rows * hkv * (d * k_q.dtype.itemsize + dv * v_q.dtype.itemsize
                       + k_s.dtype.itemsize + v_s.dtype.itemsize)
    return Work(2 * hq * rows * (d + dv), kv + _nbytes(q) + b * hq * dv * q.dtype.itemsize
                + b * _INT32)


def ssd_pairs(s: int, tile: int = SSD_TILE) -> int:
    """Causal (t, u) pairs within each ``tile``-step chunk of ``s`` steps."""
    full, rest = divmod(s, tile)
    return full * tile * (tile + 1) // 2 + rest * (rest + 1) // 2


def ssd_scan(x, dt, A, B, C, initial_state=None) -> Work:
    """x (Bt,S,H,P), dt (Bt,S,H), A (H,), B/C (Bt,S,N), initial state
    (Bt,H,P,N): C.B per chunk pair (shared by the heads), w @ x, and per step
    C h^T plus the state update (2 P N each), per head; x, dt, A, B, C and
    the initial state read, y (x's dtype) and the f32 final state written."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pairs = ssd_pairs(s)
    flops = b * (2 * pairs * n + h * (2 * pairs * p + 4 * s * p * n))
    nbytes = (2 * _nbytes(x) + _nbytes(dt) + _nbytes(A) + _nbytes(B) + _nbytes(C)
              + b * h * p * n * 4 + (_nbytes(initial_state) if initial_state is not None else 0))
    return Work(flops, nbytes)


def book(name: str, work: Work) -> None:
    """Hand one launch's work to every sink of the enclosing ``booking``s."""
    for sink in _SINKS:
        sink(name, work)


@contextlib.contextmanager
def booking(sink: Callable[[str, Work], None]):
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)
