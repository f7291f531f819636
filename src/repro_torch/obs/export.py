"""Exporters: Prometheus text exposition + JSONL span/event dumps.

* :func:`prometheus_text` renders a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  in the Prometheus text exposition format (version 0.0.4) — the thing a
  ``GET /metrics`` scrape returns.  Histograms emit cumulative ``_bucket``
  series with the standard ``le`` label plus ``_sum`` / ``_count``.
* :func:`write_jsonl` / :func:`iter_jsonl` dump and reload the tracer's
  span/event records, one strict-JSON object per line (non-finite floats are
  sanitized to ``null`` so any parser can read the file back).
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Iterable, Iterator, List, TextIO, Union

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "prometheus_text",
    "sanitize_json",
    "write_jsonl",
    "iter_jsonl",
    "write_report",
]


def sanitize_json(obj: Any) -> Any:
    """Recursively replace non-finite floats with ``None`` (strict JSON has
    no NaN/Infinity) and stringify non-JSON scalar types."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {str(k): sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    return str(obj)


def write_report(
    path: Union[str, "os.PathLike[str]", None],
    report: Dict[str, Any],
    schema: str,
    merge: bool = True,
) -> bool:
    """Write a ``BENCH_*.json`` / ``CALIBRATION.json``-style report: strict
    JSON (non-finite floats sanitized to ``null``, ``allow_nan=False``),
    stamped with ``schema`` and ``generated_unix``.

    Every machine-readable artifact in the repo goes through this one
    writer so the :mod:`benchmarks.validate_bench` CI gate's strictness
    promise holds by construction.  With ``merge=True`` (default) the new
    sections are merged over an existing report of the same schema family
    (``"placement_bench/v1"`` merges onto any ``"placement_bench/*"``),
    so e.g. a ``--trace`` run and an ``--autoscale`` run can share one
    file.  Returns True when a file was written (``path`` falsy = no-op).
    """
    if not path:
        return False
    family = schema.split("/", 1)[0] + "/"
    merged: Dict[str, Any] = {}
    if merge and os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            if isinstance(prev, dict) and str(prev.get("schema", "")).startswith(family):
                merged = prev
        except (OSError, ValueError):
            pass  # unreadable previous report: start fresh
    merged.update(report)
    merged["schema"] = schema
    merged["generated_unix"] = time.time()
    with open(path, "w") as f:
        json.dump(sanitize_json(merged), f, indent=2, sort_keys=True,
                  allow_nan=False)
    return True


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_with(inst, extra: Dict[str, str]) -> str:
    pairs = list(inst.labels) + sorted(extra.items())
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def prometheus_text(registry: MetricsRegistry, prefix: str = "repro_") -> str:
    """Render every instrument in the Prometheus text exposition format."""
    lines: List[str] = []
    for name, insts in registry.families().items():
        full = prefix + name
        first = insts[0]
        if first.help:
            lines.append(f"# HELP {full} {first.help}")
        lines.append(f"# TYPE {full} {first.kind}")
        for inst in insts:
            if isinstance(inst, Histogram):
                for ub, cum in inst.cumulative_buckets():
                    lbl = _labels_with(inst, {"le": _fmt(ub)})
                    lines.append(f"{full}_bucket{lbl} {cum}")
                lines.append(f"{full}_sum{inst.label_str()} {_fmt(inst.sum)}")
                lines.append(f"{full}_count{inst.label_str()} {inst.count}")
            elif isinstance(inst, (Counter, Gauge)):
                lines.append(f"{full}{inst.label_str()} {_fmt(inst.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(
    records: Iterable[Dict[str, Any]], dest: Union[str, "os.PathLike[str]", TextIO]
) -> int:
    """Write records one strict-JSON object per line; returns the count."""
    n = 0

    def _dump(f: TextIO) -> int:
        count = 0
        for rec in records:
            try:
                # fast path: most records are already finite + serializable
                line = json.dumps(rec, allow_nan=False, sort_keys=True)
            except (TypeError, ValueError):
                line = json.dumps(sanitize_json(rec), allow_nan=False,
                                  sort_keys=True)
            f.write(line + "\n")
            count += 1
        return count

    if isinstance(dest, (str, os.PathLike)):
        with open(dest, "w") as f:
            n = _dump(f)
    else:
        n = _dump(dest)
    return n


def iter_jsonl(
    src: Union[str, "os.PathLike[str]", TextIO]
) -> Iterator[Dict[str, Any]]:
    """Yield records back from a JSONL file or handle (strict parse)."""

    def _parse(f: TextIO) -> Iterator[Dict[str, Any]]:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)

    if isinstance(src, (str, os.PathLike)):
        with open(src) as f:
            yield from _parse(f)
    else:
        yield from _parse(src)
