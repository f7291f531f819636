"""What several readers share: the window's requests and the trace's kernels."""
from __future__ import annotations

import re
from typing import Iterable, List

FLASH = re.compile(r"fa_tc_kernel|fa_fwd_kernel|flash", re.I)
DECODE_ATTN = re.compile(r"decode_split_kernel|decode_combine_kernel|decode_q8_split_kernel")
COPY = re.compile(r"^(Memcpy|Memset)")


def sent_in_window(rec) -> List:
    """Requests due (open loop) or sent (closed loop) inside the window."""
    return [r for r in rec.requests.values() if rec.t_open <= r.sent < rec.t_close]


def ttft_s(rec) -> List[float]:
    """Each request due or sent in the window: the time from then to the end
    of the step that yielded its first token, or to the close where it had
    none by then."""
    return [(r.times[0] if r.times and r.times[0] <= rec.t_close else rec.t_close) - r.sent
            for r in sent_in_window(rec)]


def gaps_s(rec) -> List[float]:
    """Every gap between consecutive output tokens of a request that ends in
    the window."""
    return [b - a for r in rec.requests.values() for a, b in zip(r.times, r.times[1:])
            if rec.t_open < b <= rec.t_close]


def span_outside_trace(ctx, t0: float, t1: float) -> bool:
    """A timed span that the profiler's slice did not slow down."""
    b = ctx.record.trace_bounds
    return b is None or t1 <= b[0] or t0 >= b[1]


def device_seconds(acts: Iterable[tuple]) -> float:
    return sum(e - s for _, s, e in acts) * 1e-6
