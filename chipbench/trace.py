"""A ``torch.profiler`` slice of the window, reduced to what the per-layer
metrics read.  The events stay in memory; nothing is written to disk.

The reduction keeps, from the slice: every device activity (kernels,
copies, sets) as (name, start, end) in microseconds of the trace's clock;
the harness's named prefill and decode ranges on the host (see
``harness._Timed``); the union of device activity (busy); the idle gaps
between activities, each named by the harness range it fell in; and the
device time by name.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_RANGE = re.compile(r"^(chipbench\.(?:prefill|decode))#(\d+)$")


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA") and not getattr(
        e, "is_user_annotation", False) and not _RANGE.match(e.name)


def reduce(events, wall_s: float) -> Dict[str, Any]:
    """``events``: the profiler's ``events()``; ``wall_s``: the slice's
    length on the host clock (synchronized at both ends)."""
    device: List[Tuple[str, float, float]] = []
    ranges: Dict[Tuple[str, int], Tuple[float, float]] = {}
    for e in events:
        m = _RANGE.match(e.name)
        if m and not str(getattr(e, "device_type", "")).endswith("CUDA"):
            ranges[(m.group(1), int(m.group(2)))] = (e.time_range.start, e.time_range.end)
        elif _is_device(e):
            device.append((e.name, e.time_range.start, e.time_range.end))
    device.sort(key=lambda t: t[1])
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: Dict[str, float] = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)

    def host_at(t: float) -> str:
        for (kind, _), (a, b) in ranges.items():
            if a <= t <= b:
                return ("inside a prefill forward" if kind.endswith("prefill")
                        else "inside a decode forward")
        return "between forwards (engine bookkeeping, argmax sync, cache insert, harness)"

    idle = sorted(((host_at((a + b) / 2), (b - a) * 1e-6) for a, b in gaps),
                  key=lambda t: -t[1])
    return {
        "device": device,
        "ranges": ranges,
        "busy_s": busy_us * 1e-6,
        "window_s": wall_s,
        "device_ops": sorted(((n, us * 1e-6) for n, us in by_name.items()),
                             key=lambda t: -t[1])[:10],
        "idle_gaps": idle[:10],
    }


def inside(trace: Dict[str, Any], kind: str) -> Dict[int, List[Tuple[str, float, float]]]:
    """The device activities that started inside each of the harness's
    ranges of ``kind`` (``harness.PREFILL`` or ``DECODE``), by range number."""
    spans = sorted((a, b, n) for (k, n), (a, b) in trace["ranges"].items() if k == kind)
    out: Dict[int, List[Tuple[str, float, float]]] = {n: [] for _, _, n in spans}
    j = 0
    for act in trace["device"]:
        s = act[1]
        while j < len(spans) and spans[j][1] < s:
            j += 1
        if j < len(spans) and spans[j][0] <= s:
            out[spans[j][2]].append(act)
    return out
