"""Span tracing: nested wall-time spans + point events over simulated time.

Two record kinds flow through a :class:`Tracer`:

* **spans** — wall-clock intervals with causal structure.  ``tracer.span()``
  is a context manager; spans opened while another span is active become its
  children (``parent_id``), and every span carries the ``trace_id`` of its
  root, so a whole engine verb (``compact`` -> ``plan`` -> ``score`` ->
  ``commit``) reconstructs as one tree from a flat JSONL dump.
* **events** — zero-duration (or explicitly-durationed) points on an
  *arbitrary* clock, used for simulated-time marks like migration windows
  and autoscale decisions where wall time is meaningless.

The default process-global tracer is a :class:`NoopTracer`: ``span()``
returns a shared singleton whose ``__enter__``/``__exit__``/``set`` do
nothing, so instrumentation left in hot paths costs one attribute lookup and
one call when telemetry is disabled.  Seeded simulations are byte-identical
with tracing on or off — spans observe, they never touch placement state.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "SpanEvent", "Tracer", "NoopTracer", "NOOP_SPAN"]


@dataclasses.dataclass
class SpanEvent:
    """A point (or explicitly-durationed) mark on a caller-supplied clock."""

    name: str
    time: float  # caller's clock — simulated seconds at the sim call sites
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    duration: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kind": "event",
            "name": self.name,
            "time": self.time,
            "duration": self.duration,
            "attrs": dict(self.attrs),
        }


class Span:
    """One wall-time interval in a trace tree.

    Used as a context manager (via :meth:`Tracer.span`); ``set(**attrs)``
    attaches attributes at any point while open or after close.
    """

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id",
        "start_unix", "duration", "attrs", "_tracer", "_t0", "status",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        span_id: str,
        parent_id: Optional[str],
        trace_id: str,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.attrs: Dict[str, Any] = attrs or {}
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        self.duration = 0.0
        self.status = "ok"

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration = time.perf_counter() - self._t0
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self)
        return False

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kind": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start_unix": self.start_unix,
            "duration_s": self.duration,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Collects finished spans and events; maintains the open-span stack."""

    enabled = True

    def __init__(self, max_records: int = 200_000):
        #: drop-oldest cap so unbounded runs cannot exhaust memory.
        self.max_records = max_records
        self.spans: List[Span] = []
        self.events: List[SpanEvent] = []
        self._stack: List[Span] = []
        self._ids = itertools.count(1)
        self.n_dropped = 0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> Span:
        parent = self._stack[-1] if self._stack else None
        sid = f"s{next(self._ids)}"
        sp = Span(
            self,
            name,
            span_id=sid,
            parent_id=parent.span_id if parent else None,
            trace_id=parent.trace_id if parent else sid,
            attrs=attrs or None,
        )
        self._stack.append(sp)
        return sp

    def event(self, name: str, time: float, duration: float = 0.0,
              **attrs: Any) -> SpanEvent:
        ev = SpanEvent(name=name, time=time, duration=duration, attrs=attrs)
        if len(self.events) < self.max_records:
            self.events.append(ev)
        else:
            self.n_dropped += 1
        return ev

    def _finish(self, span: Span) -> None:
        # Pop to (and including) the finishing span: mis-nested exits close
        # abandoned children rather than corrupting the stack.
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
        if len(self.spans) < self.max_records:
            self.spans.append(span)
        else:
            self.n_dropped += 1

    # -- queries ------------------------------------------------------------
    @property
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children_of(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def records(self) -> List[Dict[str, Any]]:
        """All finished spans + events as JSONL-ready dicts."""
        return [s.as_dict() for s in self.spans] + [e.as_dict() for e in self.events]

    def clear(self) -> None:
        self.spans.clear()
        self.events.clear()
        self._stack.clear()
        self.n_dropped = 0


class _NoopSpan:
    """Shared do-nothing span: the disabled-telemetry fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Default tracer: every operation is a constant-time no-op."""

    enabled = False
    spans: List[Span] = []
    events: List[SpanEvent] = []

    def span(self, name: str, **attrs: Any) -> _NoopSpan:
        return NOOP_SPAN

    def event(self, name: str, time: float, duration: float = 0.0,
              **attrs: Any) -> None:
        return None

    def records(self) -> List[Dict[str, Any]]:
        return []

    def find(self, name: str) -> List[Span]:
        return []

    def clear(self) -> None:
        pass
