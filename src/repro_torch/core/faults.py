"""Seeded fault injection for the online simulators.
Copy of ``repro/core/faults.py``.

A production MIG fleet loses capacity involuntarily: GPUs die, single
memory slices go bad (row-remapping exhaustion), nodes get drained for
kernel upgrades, and maintenance windows take whole hosts away.  This
module turns those incidents into a deterministic, replayable event
stream that ``OnlineSimulator`` / ``DemandSimulator`` merge with their
arrival traffic:

  * ``FaultSpec``     — one fault *class*: kind + Poisson rate and/or
                        explicit times, targets hit per event, and an
                        optional auto-repair duration (MTTR)
  * ``FaultEvent``    — one concrete incident (or its paired ``repair``)
                        aimed at a specific GPU
  * ``FaultInjector`` — expands specs into a sorted event schedule

Determinism contract (mirrors ``traffic.generate_requests``): the
injector derives one ``SeedSequence`` substream per spec, so adding,
removing, or re-parameterizing one fault spec never perturbs the events
drawn for the others — and the injector never touches the arrival
streams' RNGs at all, so a run with ``FaultInjector([])`` is
byte-identical to a run with no injector.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .state import ClusterState

__all__ = [
    "FAULT_KINDS",
    "FaultSpec",
    "FaultEvent",
    "FaultInjector",
]

#: injectable incident kinds ("repair" events are derived, not injected).
FAULT_KINDS = (
    "gpu_failure",
    "slice_failure",
    "node_drain",
    "maintenance_window",
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One class of fault to inject over a trace.

    Events fire at every time in ``at`` plus a Poisson process of
    ``rate`` events/second over the horizon; each event hits ``count``
    distinct GPUs drawn (without replacement) from ``gids`` (default:
    the whole fleet).  ``duration`` > 0 schedules a paired ``repair``
    event (the incident's MTTR — drains and maintenance windows end,
    hardware gets swapped); 0 means the target stays down for the rest
    of the trace.
    """

    kind: str
    rate: float = 0.0
    at: Tuple[float, ...] = ()
    count: int = 1
    duration: float = 0.0
    gids: Tuple[str, ...] = ()
    name: str = ""

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        if self.rate < 0 or self.duration < 0 or self.count < 1:
            raise ValueError(f"invalid fault spec: {self}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One concrete incident (or its auto-repair) aimed at a GPU."""

    time: float
    kind: str  # one of FAULT_KINDS, or "repair"
    gid: str
    #: failed memory position for ``slice_failure`` (-1 otherwise).
    index: int = -1
    #: MTTR carried on the incident (0 = permanent; repairs carry 0).
    duration: float = 0.0
    #: originating spec name (diagnostics / telemetry labels).
    spec: str = ""


class FaultInjector:
    """Expands ``FaultSpec``s into a deterministic ``FaultEvent`` schedule.

    Per-spec ``SeedSequence`` substreams (same pattern as
    ``traffic.generate_requests``) keep specs independent: spec *i*'s
    times and targets depend only on ``(seed, i)``.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed

    def schedule(self, fleet: ClusterState, horizon: float) -> List[FaultEvent]:
        """All fault + repair events over ``[0, horizon)`` for ``fleet``.

        Repairs are paired at schedule time (incident time + duration)
        and may land past the horizon — the simulators still apply them
        (health is restored) but clamp any accounting to the horizon.
        """
        if not self.specs:
            return []
        events: List[FaultEvent] = []
        streams = np.random.SeedSequence(self.seed).spawn(len(self.specs))
        for spec, stream in zip(self.specs, streams):
            rng = np.random.default_rng(stream)
            pool = [
                g for g in (sorted(spec.gids) or fleet.ordered_gids())
                if g in fleet.gpus
            ]
            times = [float(t) for t in spec.at if 0.0 <= t < horizon]
            if spec.rate > 0.0:
                t = 0.0
                while True:
                    t += float(rng.exponential(1.0 / spec.rate))
                    if t >= horizon:
                        break
                    times.append(t)
            label = spec.name or spec.kind
            for t in sorted(times):
                if not pool:
                    break
                k = min(spec.count, len(pool))
                picks = sorted(
                    int(i) for i in rng.choice(len(pool), size=k, replace=False)
                )
                for j in picks:
                    gid = pool[j]
                    index = -1
                    if spec.kind == "slice_failure":
                        index = int(rng.integers(
                            0, fleet.gpus[gid].device.n_memory_slices
                        ))
                    events.append(FaultEvent(
                        time=t, kind=spec.kind, gid=gid, index=index,
                        duration=spec.duration, spec=label,
                    ))
                    if spec.duration > 0.0:
                        events.append(FaultEvent(
                            time=t + spec.duration, kind="repair", gid=gid,
                            index=index, spec=label,
                        ))
        events.sort(key=lambda e: (e.time, e.kind, e.gid))
        return events
