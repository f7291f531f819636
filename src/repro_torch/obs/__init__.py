"""repro_torch.obs — zero-dependency fleet telemetry (spans, metrics, exporters).
A copy of the reference's ``obs`` package; metric names keep the
``repro_`` prefix, so both packages export the same exposition.

The control plane (engine verbs, online/demand simulators, placement
fabric, serving cluster) and the serving path (the continuous-batching
``serving.engine.Engine``, ``serving.kvcache.insert_prefix`` and the model's
``Model.forward``: embedding, each block, the head) are instrumented
against a process-global :class:`Telemetry` handle.  The default handle is
a **no-op**: seeded runs stay byte-identical and the instrumentation costs
one global read plus one no-op call per site.  Opt in explicitly:

    from repro_torch import obs

    tel = obs.enable()                  # install a live Telemetry
    ... run simulations / engine verbs / the cluster server ...
    print(obs.prometheus_text(tel.metrics))          # scrape-format dump
    obs.write_jsonl(tel.tracer.records(), "trace.jsonl")
    obs.disable()                       # restore the no-op default

Render a JSONL trace afterwards:

    python -m repro_torch.obs.report trace.jsonl      # latency table + timeline
    python -m repro_torch.obs.report trace.jsonl --html t.html

Layers (see the submodules for detail):

* ``trace``   — ``Tracer`` / ``Span``: nested wall-time spans with causal
  parent ids, on the host's ``perf_counter`` clock and, while a
  ``torch.profiler`` session records, as its ranges too; plus point events.
* ``metrics`` — ``MetricsRegistry``: counters / gauges / histograms with
  fixed-capacity ring-buffer time series and numpy-compatible percentile
  math.
* ``export``  — Prometheus text exposition and strict-JSON JSONL span/event
  dumps.
* ``report``  — per-verb latency tables and an ASCII/HTML timeline of
  migration windows and autoscale decisions.
* ``host``    — host-contention guard for bench entrypoints (stale
  ``pytest``/bench processes, load average) -> ``contended`` flag.
* ``profile`` — kernel calibration profiler: measures the
  ``repro_torch.kernels`` ops under MIG-profile-shaped budgets and builds the
  ``CALIBRATION.json`` artifact ``PerfModel.from_calibration`` consumes.
  (Imported lazily — ``repro_torch.obs`` itself does not import the kernels.)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Union

from .export import (
    iter_jsonl,
    prometheus_text,
    sanitize_json,
    write_jsonl,
    write_report,
)
from .host import host_snapshot
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NoopMetricsRegistry,
    TimeSeries,
)
from .trace import NoopTracer, Span, SpanEvent, Tracer

__all__ = [
    "Telemetry",
    "get_telemetry",
    "set_telemetry",
    "enable",
    "disable",
    "enabled",
    "Tracer",
    "NoopTracer",
    "Span",
    "SpanEvent",
    "MetricsRegistry",
    "NoopMetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "TimeSeries",
    "prometheus_text",
    "write_jsonl",
    "iter_jsonl",
    "sanitize_json",
    "write_report",
    "host_snapshot",
]


@dataclasses.dataclass
class Telemetry:
    """One tracer + one metrics registry behind a single on/off switch.

    ``enabled`` is the hot-path guard: instrumented code may skip computing
    expensive attributes (fleet fragmentation, byte totals) when False.
    """

    tracer: Union[Tracer, NoopTracer]
    metrics: Union[MetricsRegistry, NoopMetricsRegistry]
    enabled: bool = True

    @classmethod
    def live(cls, max_records: int = 200_000,
             series_capacity: int = 1024) -> "Telemetry":
        return cls(
            tracer=Tracer(max_records=max_records),
            metrics=MetricsRegistry(series_capacity=series_capacity),
            enabled=True,
        )

    @classmethod
    def noop(cls) -> "Telemetry":
        return cls(tracer=NoopTracer(), metrics=NoopMetricsRegistry(),
                   enabled=False)


_NOOP = Telemetry.noop()
_ACTIVE: Telemetry = _NOOP


def get_telemetry() -> Telemetry:
    """The process-global handle every instrumentation site reads."""
    return _ACTIVE


def set_telemetry(tel: Optional[Telemetry]) -> Telemetry:
    """Install ``tel`` (None restores the no-op default); returns it."""
    global _ACTIVE
    _ACTIVE = tel if tel is not None else _NOOP
    return _ACTIVE


def enable(max_records: int = 200_000, series_capacity: int = 1024) -> Telemetry:
    """Install and return a fresh live Telemetry."""
    return set_telemetry(
        Telemetry.live(max_records=max_records, series_capacity=series_capacity)
    )


def disable() -> None:
    """Restore the no-op default (recorded data on the old handle survives)."""
    set_telemetry(None)


@contextlib.contextmanager
def enabled(tel: Optional[Telemetry] = None) -> Iterator[Telemetry]:
    """Scoped enablement: install ``tel`` (or a fresh live handle) for the
    ``with`` body, then restore whatever was active before."""
    prev = get_telemetry()
    active = set_telemetry(tel if tel is not None else Telemetry.live())
    try:
        yield active
    finally:
        set_telemetry(prev)
