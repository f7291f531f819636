"""Trace report: per-verb latency tables + migration/autoscale timelines.
Copy of ``repro/obs/report.py``.

Turns a JSONL span/event dump (``obs.write_jsonl(tracer.records(), path)``;
any telemetry-enabled run can write one) into something an SRE can read:

    python -m repro_torch.obs.report trace.jsonl
    python -m repro_torch.obs.report trace.jsonl --html timeline.html

* **latency table** — one row per span name (engine verbs and their
  plan/score/commit children, plan execution steps, autoscale ticks):
  count, total seconds, p50/p95/p99.
* **timeline** — simulated-time lanes over the trace horizon: migration
  windows render as filled intervals, autoscale decisions as +/- marks,
  plan rejections and deferrals as points.  The HTML variant renders the
  same lanes as positioned blocks with hover tooltips.

Pure stdlib; numpy-free on purpose (the report must run anywhere the JSONL
landed, e.g. a laptop reading a CI artifact).
"""
from __future__ import annotations

import argparse
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .export import iter_jsonl

__all__ = [
    "load_records",
    "latency_table",
    "format_latency_table",
    "ascii_timeline",
    "html_timeline",
    "render_report",
    "main",
]

#: event names drawn as filled intervals (everything else is a point mark).
_INTERVAL_EVENTS = ("migration_window",)
#: point-mark glyphs per event name (default "*").
_MARKS = {
    "autoscale_up": "+",
    "autoscale_down": "-",
    "autoscale_resize": "~",
    "plan_rejected": "x",
    "verb_deferred": "d",
}


def _percentile(vals: List[float], q: float) -> float:
    """numpy.percentile (linear interpolation), stdlib-only."""
    if not vals:
        return float("nan")
    vals = sorted(vals)
    pos = (len(vals) - 1) * (q / 100.0)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if lo == hi:
        return vals[lo]
    return vals[lo] * (1.0 - (pos - lo)) + vals[hi] * (pos - lo)


def load_records(path: str) -> Tuple[List[Dict], List[Dict]]:
    """(spans, events) from a JSONL dump, in file order."""
    spans: List[Dict] = []
    events: List[Dict] = []
    for rec in iter_jsonl(path):
        kind = rec.get("kind")
        if kind == "span":
            spans.append(rec)
        elif kind == "event":
            events.append(rec)
    return spans, events


# ---------------------------------------------------------------------------
# latency table
# ---------------------------------------------------------------------------
def latency_table(spans: Iterable[Dict]) -> List[Dict[str, Any]]:
    """Per span-name latency stats, ordered by total time descending."""
    by_name: Dict[str, List[float]] = {}
    for sp in spans:
        d = sp.get("duration_s")
        if d is not None:
            by_name.setdefault(sp["name"], []).append(float(d))
    rows = []
    for name, durs in by_name.items():
        rows.append({
            "name": name,
            "count": len(durs),
            "total_s": sum(durs),
            "p50_s": _percentile(durs, 50),
            "p95_s": _percentile(durs, 95),
            "p99_s": _percentile(durs, 99),
            "max_s": max(durs),
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def format_latency_table(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "(no spans)"
    width = max(12, max(len(r["name"]) for r in rows) + 2)
    cols = ("count", "total_s", "p50_s", "p95_s", "p99_s", "max_s")
    out = ["span".ljust(width) + "".join(c.rjust(12) for c in cols)]
    for r in rows:
        line = r["name"].ljust(width) + f"{r['count']:12d}"
        for c in cols[1:]:
            line += f"{r[c]:12.5f}"
        out.append(line)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# timelines
# ---------------------------------------------------------------------------
def _lanes(events: List[Dict]) -> Dict[str, List[Dict]]:
    lanes: Dict[str, List[Dict]] = {}
    for ev in events:
        lanes.setdefault(ev["name"], []).append(ev)
    return lanes


def _horizon(events: List[Dict]) -> float:
    hi = 0.0
    for ev in events:
        hi = max(hi, float(ev.get("time", 0.0)) + float(ev.get("duration", 0.0)))
    return hi


def ascii_timeline(events: List[Dict], width: int = 72,
                   horizon: Optional[float] = None) -> str:
    """One character lane per event name over simulated time."""
    if not events:
        return "(no events)"
    hi = horizon if horizon is not None else _horizon(events)
    hi = max(hi, 1e-9)
    scale = (width - 1) / hi
    lanes = _lanes(events)
    label_w = max(len(n) for n in lanes) + 2
    lines = [
        " " * label_w + f"0{'sim seconds'.center(width - 8)}{hi:7.1f}",
        " " * label_w + "|" + "-" * (width - 2) + "|",
    ]
    for name in sorted(lanes):
        row = [" "] * width
        for ev in lanes[name]:
            a = int(float(ev["time"]) * scale)
            if name in _INTERVAL_EVENTS and float(ev.get("duration", 0.0)) > 0:
                b = int((float(ev["time"]) + float(ev["duration"])) * scale)
                for i in range(max(a, 0), min(max(b, a + 1), width)):
                    row[i] = "#"
            elif 0 <= a < width:
                row[a] = _MARKS.get(name, "*")
        lines.append(name.ljust(label_w) + "".join(row))
    return "\n".join(lines)


_HTML_HEAD = """<!doctype html><meta charset="utf-8">
<title>repro_torch.obs trace report</title>
<style>
 body { font: 13px/1.4 system-ui, sans-serif; margin: 24px; }
 table { border-collapse: collapse; margin-bottom: 24px; }
 th, td { padding: 2px 10px; text-align: right; border-bottom: 1px solid #ddd; }
 th:first-child, td:first-child { text-align: left; }
 .lane { position: relative; height: 18px; background: #f4f4f4;
         margin: 2px 0 2px 180px; }
 .lane-label { position: absolute; left: -180px; width: 172px;
               text-align: right; color: #555; }
 .iv { position: absolute; top: 2px; bottom: 2px; background: #4a7fb5;
       opacity: .8; min-width: 2px; }
 .pt { position: absolute; top: 4px; width: 3px; bottom: 6px;
       background: #b5564a; }
</style>
"""


def html_timeline(events: List[Dict], spans: List[Dict],
                  horizon: Optional[float] = None) -> str:
    """Self-contained HTML: the latency table + positioned timeline lanes."""
    rows = latency_table(spans)
    hi = max(horizon if horizon is not None else _horizon(events), 1e-9)
    parts = [_HTML_HEAD, "<h2>Per-span latency</h2><table>",
             "<tr><th>span</th><th>count</th><th>total&nbsp;s</th>"
             "<th>p50</th><th>p95</th><th>p99</th></tr>"]
    for r in rows:
        parts.append(
            f"<tr><td>{r['name']}</td><td>{r['count']}</td>"
            f"<td>{r['total_s']:.5f}</td><td>{r['p50_s']:.5f}</td>"
            f"<td>{r['p95_s']:.5f}</td><td>{r['p99_s']:.5f}</td></tr>"
        )
    parts.append("</table>")
    parts.append(f"<h2>Timeline (0 &ndash; {hi:.1f} sim s)</h2>")
    for name, evs in sorted(_lanes(events).items()):
        parts.append(f'<div class="lane"><span class="lane-label">{name}</span>')
        for ev in evs:
            left = 100.0 * float(ev["time"]) / hi
            attrs = ", ".join(f"{k}={v}" for k, v in (ev.get("attrs") or {}).items())
            title = f't={ev["time"]:.1f}s {attrs}'
            if name in _INTERVAL_EVENTS and float(ev.get("duration", 0.0)) > 0:
                w = 100.0 * float(ev["duration"]) / hi
                parts.append(
                    f'<div class="iv" title="{title}" '
                    f'style="left:{left:.2f}%;width:{w:.2f}%"></div>'
                )
            else:
                parts.append(
                    f'<div class="pt" title="{title}" '
                    f'style="left:{left:.2f}%"></div>'
                )
        parts.append("</div>")
    return "".join(parts)


def render_report(path: str, width: int = 72) -> str:
    """The full ASCII report for one JSONL dump."""
    spans, events = load_records(path)
    out = [
        f"trace: {path} — {len(spans)} spans, {len(events)} events",
        "",
        "== per-span latency (wall seconds) ==",
        format_latency_table(latency_table(spans)),
        "",
        "== simulated-time timeline ==",
        ascii_timeline(events, width=width),
    ]
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a repro_torch.obs JSONL trace as latency tables "
        "and migration/autoscale timelines.",
    )
    ap.add_argument("trace", help="JSONL span/event dump")
    ap.add_argument("--width", type=int, default=72,
                    help="ASCII timeline width in characters")
    ap.add_argument("--html", default=None, metavar="PATH",
                    help="also write a self-contained HTML report")
    args = ap.parse_args(argv)
    print(render_report(args.trace, width=args.width))
    if args.html:
        spans, events = load_records(args.trace)
        with open(args.html, "w") as f:
            f.write(html_timeline(events, spans))
        print(f"\nwrote {args.html}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
