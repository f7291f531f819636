"""Metrics registry: counters / gauges / histograms with ring-buffer series.

Instruments are created through a :class:`MetricsRegistry` and addressed by
``(name, labels)`` — the Prometheus data model, minus the dependency:

    reg = MetricsRegistry()
    reg.counter("plans_committed_total", "committed plans").inc()
    reg.histogram("planner_latency_seconds", "verb latency",
                  labels={"verb": "compact"}).observe(0.012)
    reg.gauge("gpus_used", "fleet occupancy").set(34, t=sim_now)

Every instrument keeps a fixed-capacity **ring buffer** of ``(t, value)``
points (drop-oldest), so long online simulations retain a bounded recent
time series per metric — the continuous fragmentation/utilization signals
MISO-style repartitioning presumes.  ``t`` defaults to wall time but call
sites on the simulators pass the simulated clock.

Histograms additionally keep Prometheus-style cumulative bucket counts plus
a bounded reservoir of raw observations; ``percentile()`` matches
``numpy.percentile`` (linear interpolation) on the retained reservoir —
property-tested in ``tests/test_obs.py``.

The registry is deterministic: no randomness, insertion-ordered iteration,
and nothing here ever touches placement state.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "TimeSeries",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NoopMetricsRegistry",
    "DEFAULT_BUCKETS",
]

#: default histogram buckets (seconds-flavored: micro-latency to minutes).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)

LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Optional[Mapping[str, object]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class TimeSeries:
    """Fixed-capacity ring buffer of (t, value) points (drop-oldest)."""

    __slots__ = ("capacity", "_t", "_v", "_head", "_n")

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._t: List[float] = [0.0] * capacity
        self._v: List[float] = [0.0] * capacity
        self._head = 0  # next write position
        self._n = 0

    def append(self, t: float, v: float) -> None:
        self._t[self._head] = t
        self._v[self._head] = v
        self._head = (self._head + 1) % self.capacity
        if self._n < self.capacity:
            self._n += 1

    def __len__(self) -> int:
        return self._n

    def points(self) -> List[Tuple[float, float]]:
        """Chronological (t, value) pairs currently retained."""
        if self._n < self.capacity:
            idx: Iterable[int] = range(self._n)
        else:
            idx = (
                (self._head + i) % self.capacity for i in range(self.capacity)
            )
        return [(self._t[i], self._v[i]) for i in idx]

    def values(self) -> List[float]:
        return [v for _, v in self.points()]


class _Instrument:
    """Shared base: identity + ring-buffer series."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: LabelSet,
                 series_capacity: int = 1024):
        self.name = name
        self.help = help_
        self.labels = labels
        self.series = TimeSeries(series_capacity)

    def _now(self, t: Optional[float]) -> float:
        return time.time() if t is None else t

    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return "{" + inner + "}"


class Counter(_Instrument):
    """Monotonic cumulative count; the series records the running total."""

    kind = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0.0

    def inc(self, amount: float = 1.0, t: Optional[float] = None) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount
        self.series.append(self._now(t), self.value)


class Gauge(_Instrument):
    """A value that goes up and down; the series records each set/add."""

    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0.0

    def set(self, value: float, t: Optional[float] = None) -> None:
        self.value = float(value)
        self.series.append(self._now(t), self.value)

    def add(self, amount: float, t: Optional[float] = None) -> None:
        self.set(self.value + amount, t=t)


class Histogram(_Instrument):
    """Prometheus-style cumulative buckets + a bounded raw reservoir.

    The reservoir (same ring-buffer discipline as the series) backs
    :meth:`percentile`; with fewer observations than the reservoir capacity
    the percentiles are exact.
    """

    kind = "histogram"

    def __init__(self, name: str, help_: str, labels: LabelSet,
                 series_capacity: int = 1024,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labels, series_capacity)
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.count = 0
        self.sum = 0.0
        self.reservoir = TimeSeries(series_capacity)

    def observe(self, value: float, t: Optional[float] = None) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.bucket_counts[i] += 1
                break
        else:
            self.bucket_counts[-1] += 1
        now = self._now(t)
        self.series.append(now, value)
        self.reservoir.append(now, value)

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative count) pairs, +Inf last."""
        out: List[Tuple[float, int]] = []
        running = 0
        for ub, c in zip(self.buckets, self.bucket_counts):
            running += c
            out.append((ub, running))
        out.append((math.inf, running + self.bucket_counts[-1]))
        return out

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the retained reservoir, linear
        interpolation — matches ``numpy.percentile`` defaults."""
        vals = sorted(self.reservoir.values())
        if not vals:
            return float("nan")
        if not 0.0 <= q <= 100.0:
            raise ValueError("q must be in [0, 100]")
        pos = (len(vals) - 1) * (q / 100.0)
        lo = int(math.floor(pos))
        hi = int(math.ceil(pos))
        if lo == hi:
            return vals[lo]
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}


class MetricsRegistry:
    """Creates and holds instruments keyed by (name, labels).

    Repeat calls with the same identity return the same instrument, so call
    sites never need to cache handles (though hot paths may).
    """

    enabled = True

    def __init__(self, series_capacity: int = 1024):
        self.series_capacity = series_capacity
        self._instruments: Dict[Tuple[str, LabelSet], _Instrument] = {}
        self._helps: Dict[str, str] = {}

    def _get(self, cls, name: str, help_: str,
             labels: Optional[Mapping[str, object]], **kwargs):
        key = (name, _labelset(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(name, help_ or self._helps.get(name, ""), key[1],
                       series_capacity=self.series_capacity, **kwargs)
            self._instruments[key] = inst
            self._helps.setdefault(name, inst.help)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}"
            )
        return inst

    def counter(self, name: str, help_: str = "",
                labels: Optional[Mapping[str, object]] = None) -> Counter:
        return self._get(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: Optional[Mapping[str, object]] = None) -> Gauge:
        return self._get(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Optional[Mapping[str, object]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, labels, buckets=buckets)

    # -- queries ------------------------------------------------------------
    def instruments(self) -> List[_Instrument]:
        return list(self._instruments.values())

    def families(self) -> Dict[str, List[_Instrument]]:
        """name -> instruments (one per label set), insertion-ordered."""
        fams: Dict[str, List[_Instrument]] = {}
        for inst in self._instruments.values():
            fams.setdefault(inst.name, []).append(inst)
        return fams

    def get(self, name: str,
            labels: Optional[Mapping[str, object]] = None) -> Optional[_Instrument]:
        return self._instruments.get((name, _labelset(labels)))

    def clear(self) -> None:
        self._instruments.clear()
        self._helps.clear()


class _NoopInstrument:
    """Accepts every instrument method and does nothing."""

    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, amount: float = 1.0, t: Optional[float] = None) -> None:
        pass

    def set(self, value: float, t: Optional[float] = None) -> None:
        pass

    def add(self, amount: float, t: Optional[float] = None) -> None:
        pass

    def observe(self, value: float, t: Optional[float] = None) -> None:
        pass

    def percentile(self, q: float) -> float:
        return float("nan")

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        return {}


_NOOP_INSTRUMENT = _NoopInstrument()


class NoopMetricsRegistry:
    """Default registry: constant-time no-ops, nothing retained."""

    enabled = False

    def counter(self, name: str, help_: str = "",
                labels: Optional[Mapping[str, object]] = None) -> _NoopInstrument:
        return _NOOP_INSTRUMENT

    def gauge(self, name: str, help_: str = "",
              labels: Optional[Mapping[str, object]] = None) -> _NoopInstrument:
        return _NOOP_INSTRUMENT

    def histogram(self, name: str, help_: str = "",
                  labels: Optional[Mapping[str, object]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _NoopInstrument:
        return _NOOP_INSTRUMENT

    def instruments(self) -> List[_Instrument]:
        return []

    def families(self) -> Dict[str, List[_Instrument]]:
        return {}

    def get(self, name: str,
            labels: Optional[Mapping[str, object]] = None) -> None:
        return None

    def clear(self) -> None:
        pass
