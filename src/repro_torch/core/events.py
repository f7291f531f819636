"""Event-driven online placement simulation (beyond-paper).
Copy of ``repro/core/events.py``, with one addition: an arrival pool for
the H100 80GB (the A100 80GB's, since the two share a MIG geometry).

The paper's three use cases are snapshots of one *online* problem: replicas
arrive, depart, and burst over time while the scheduler periodically
compacts the fleet.  This module simulates that problem over timestamped
traces and heterogeneous fleets (e.g. MIG A100s next to TPU pods), driving
any ``PlacementEngine`` policy:

  * ``Event``          — arrival (possibly a burst of several workloads),
                         departure, or a compaction trigger
  * ``generate_trace`` — seeded Poisson arrivals with exponential lifetimes
                         and occasional bursts, routed across device kinds
                         in proportion to fleet capacity
  * ``OnlineSimulator``— replays a trace through an engine and integrates
                         time-averaged fleet metrics.  Compactions run
                         through the engine's plan/score/commit control
                         plane: a rejected plan is a transactional rollback
                         (no clone-and-restore), a committed plan opens a
                         *migration window* over simulated time — its
                         wave-parallel copies and disruptive drains occupy
                         ``duration_seconds``, during which further
                         compaction triggers are deferred — and its bytes
                         moved / downtime accrue into ``TraceStats``.

Time-averaged metrics follow the fleet-scale axis: what matters online
is not one snapshot's GPU count but the integral of GPUs-used (energy /
cost) and wastage over the trace horizon — now alongside the paper's real
constraint, disruption-minutes spent migrating.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import get_telemetry
from .autoscaler import SLO, Autoscaler, ModelLoad
from .engine import PlacementEngine
from .faults import FAULT_KINDS, FaultEvent, FaultInjector
from .fleetgen import FleetSpec, build_fleet  # noqa: F401  (re-exported API)
from .migration import CommitPolicy
from .perfmodel import PerfModel
from .profiles import DeviceModel
from .state import ClusterState, Workload
from .traffic import RequestArrival, RequestShape, RequestTrace

__all__ = [
    "Event",
    "Trace",
    "FleetSpec",
    "build_fleet",
    "generate_trace",
    "TraceStats",
    "OnlineSimulator",
    "ModelServiceSpec",
    "DemandSimulator",
]

#: event kinds the fault-injection path dispatches on (incidents + repairs).
_FAULT_EVENT_KINDS = frozenset(FAULT_KINDS) | {"repair"}

#: FaultEvent.kind -> GPU health mark applied on impact.
_HEALTH_FOR = {
    "gpu_failure": "failed",
    "slice_failure": "degraded",
    "node_drain": "draining",
    "maintenance_window": "maintenance",
}

#: FaultEvent.kind -> TraceStats counter bumped on impact.
_FAULT_COUNTERS = {
    "gpu_failure": "n_gpu_failures",
    "slice_failure": "n_slice_failures",
    "node_drain": "n_node_drains",
    "maintenance_window": "n_maintenance_windows",
}


@dataclasses.dataclass
class _Incident:
    """One fault's eviction set, tracked until recovery completes."""

    t0: float
    remaining: set
    done_at: float = 0.0
    recorded: bool = False

#: default per-device profile pools for random arrivals (same spirit as
#: simulator._DEFAULT_PROFILE_POOL: skip the trivially-whole-device profile).
_ARRIVAL_POOLS: Dict[str, Tuple[int, ...]] = {
    "A100-80GB": (5, 9, 14, 15, 19),
    "H100-80GB": (5, 9, 14, 15, 19),
    "H100-96GB": (5, 9, 14, 15, 19),
    "TPUv5e-16x16-pod": (1, 2, 3, 4),
}


def _pool_for(device: DeviceModel) -> Tuple[int, ...]:
    if device.name in _ARRIVAL_POOLS:
        return _ARRIVAL_POOLS[device.name]
    return tuple(
        p.profile_id for p in device.profiles_sorted_desc()[1:]
    ) or (device.profiles[0].profile_id,)


@dataclasses.dataclass(frozen=True)
class Event:
    """One timestamped trace event."""

    time: float
    kind: str  # "arrival" | "departure" | "compact"
    workloads: Tuple[Workload, ...] = ()  # arrivals; len > 1 == burst
    wids: Tuple[str, ...] = ()  # departures


@dataclasses.dataclass
class Trace:
    events: List[Event]
    horizon: float

    def __post_init__(self) -> None:
        self.events.sort(key=lambda e: (e.time, e.kind))

    @property
    def n_arrivals(self) -> int:
        return sum(len(e.workloads) for e in self.events if e.kind == "arrival")


def generate_trace(
    seed: int,
    fleet: ClusterState,
    horizon: float = 200.0,
    arrival_rate: float = 1.0,
    mean_lifetime: float = 40.0,
    burst_prob: float = 0.1,
    burst_size: Tuple[int, int] = (3, 6),
) -> Trace:
    """Seeded online trace over ``fleet``.

    Arrivals are Poisson(``arrival_rate``); each arrival is a single
    workload, or with ``burst_prob`` a burst of several (a model scaling out
    under load).  Lifetimes are exponential with ``mean_lifetime``; deaths
    past the horizon are dropped (the replica outlives the trace).  Each
    workload targets a device kind with probability proportional to that
    kind's share of fleet memory slices.
    """
    rng = np.random.default_rng(seed)
    kinds: Dict[str, DeviceModel] = {}
    weights: Dict[str, float] = {}
    for gpu in fleet.gpus.values():
        kinds[gpu.device.name] = gpu.device
        weights[gpu.device.name] = (
            weights.get(gpu.device.name, 0.0) + gpu.device.n_memory_slices
        )
    names = sorted(kinds)
    probs = np.array([weights[n] for n in names], dtype=float)
    probs /= probs.sum()

    events: List[Event] = []
    t = 0.0
    wi = 0
    while True:
        t += float(rng.exponential(1.0 / arrival_rate))
        if t >= horizon:
            break
        n = 1
        if float(rng.random()) < burst_prob:
            n = int(rng.integers(burst_size[0], burst_size[1] + 1))
        ws: List[Workload] = []
        for _ in range(n):
            kind = names[int(rng.choice(len(names), p=probs))]
            pool = _pool_for(kinds[kind])
            pid = int(pool[int(rng.choice(len(pool)))])
            w = Workload(wid=f"t{wi}", profile_id=pid, device_kind=kind)
            wi += 1
            ws.append(w)
            death = t + float(rng.exponential(mean_lifetime))
            if death < horizon:
                events.append(Event(time=death, kind="departure", wids=(w.wid,)))
        events.append(Event(time=t, kind="arrival", workloads=tuple(ws)))
    return Trace(events=events, horizon=horizon)


@dataclasses.dataclass
class TraceStats:
    """Time-averaged fleet metrics over one trace replay."""

    policy: str
    horizon: float
    time_avg_gpus_used: float
    time_avg_compute_waste: float
    time_avg_memory_waste: float
    time_avg_mem_occupancy: float  # used / total memory slices, whole fleet
    peak_gpus_used: int
    n_arrived: int = 0
    n_placed: int = 0
    n_rejected: int = 0
    n_departed: int = 0
    n_migrations: int = 0
    n_compactions: int = 0
    n_compactions_skipped: int = 0  # compaction plan rejected by CommitPolicy
    n_compactions_deferred: int = 0  # trigger fell inside a migration window
    n_reconfigures: int = 0
    n_reconfigures_deferred: int = 0
    n_plans_rejected: int = 0  # all rejected plans (compact + reconfigure)
    #: rejected plans by the CommitPolicy's deciding term (e.g.
    #: ``net-benefit``, ``moves``, ``downtime``) — the structured "why"
    #: behind ``n_plans_rejected``.
    plan_rejections: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: most recent rejection's human-readable reason ("" if none).
    last_rejection_reason: str = ""
    bytes_moved: float = 0.0
    disruption_seconds: float = 0.0  # summed per-replica unavailability
    migration_window_seconds: float = 0.0  # wall-clock spent migrating
    engine_seconds: float = 0.0
    # -- demand-driven accounting (DemandSimulator only) --------------------
    n_requests: int = 0
    n_completed: int = 0
    n_unserved: int = 0  # still queued when the simulation ended
    n_autoscale_ticks: int = 0
    n_scale_ups: int = 0  # replicas added by the autoscaler
    n_scale_downs: int = 0  # replicas retired by the autoscaler
    n_resizes: int = 0  # replicas re-deployed at a different profile
    n_deploy_rejected: int = 0  # scale-up replicas the engine could not place
    time_avg_queue_depth: float = 0.0
    peak_queue_depth: int = 0
    ttft_p50: float = 0.0
    ttft_p95: float = 0.0
    ttft_p99: float = 0.0
    tpot_p50: float = 0.0
    tpot_p95: float = 0.0
    tpot_p99: float = 0.0
    #: fraction of ALL arrived requests meeting their model's SLO (a request
    #: never served counts as a miss — undersized fleets can't hide).
    slo_attainment: float = 1.0
    slo_attainment_by_model: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    # -- fault injection & recovery (faults= on either simulator) -----------
    n_gpu_failures: int = 0
    n_slice_failures: int = 0
    n_node_drains: int = 0
    n_maintenance_windows: int = 0
    n_repairs: int = 0
    n_fault_noops: int = 0  # fault/repair aimed at an already-down/up target
    n_fault_evictions: int = 0  # replicas evicted by faults
    n_fault_recovered: int = 0  # evicted replicas re-placed by the engine
    n_recovery_pending: int = 0  # still waiting for capacity at horizon
    n_ghost_departures: int = 0  # departures of already-evicted workloads
    n_emergency_commits: int = 0  # escalated verbs committed during recovery
    recovery_seconds_total: float = 0.0  # summed time-to-full-recovery
    recovery_seconds_max: float = 0.0  # slowest incident's recovery time
    capacity_lost_gpu_seconds: float = 0.0  # integral of down GPU-equivalents
    # -- demand-layer fault damage (DemandSimulator only) --------------------
    n_requeued_requests: int = 0  # in-flight requests requeued by evictions
    n_shed_requests: int = 0  # best-effort arrivals shed during brownout
    brownout_seconds: float = 0.0  # wall-clock with recovery pending

    @property
    def disruption_minutes(self) -> float:
        return self.disruption_seconds / 60.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["disruption_minutes"] = self.disruption_minutes
        return d


class OnlineSimulator:
    """Replays a trace through a PlacementEngine over a live ClusterState."""

    def __init__(
        self,
        state: ClusterState,
        engine: PlacementEngine,
        compact_every: Optional[float] = None,
        migration_budget: Optional[int] = None,
        reconfigure_every: Optional[float] = None,
        faults: Optional[FaultInjector] = None,
    ):
        self.state = state
        self.engine = engine
        self.compact_every = compact_every
        #: seeded fault injector (None = no faults; the clean path draws no
        #: extra RNG samples and replays byte-identically to pre-fault code).
        self.faults = faults
        self._recovery_queue: List[Workload] = []
        self._fault_evicted: set = set()
        self._incidents: List[_Incident] = []
        #: integral bookkeeping for capacity_lost_gpu_seconds.
        self._lost_units = 0.0  # GPU-equivalents currently down
        self._lost_mark = 0.0  # last accrual time (clamped to horizon)
        self._unit_frac: Dict[str, float] = {}  # gid -> its lost fraction
        self._horizon = 0.0
        #: periodic maintenance repack (paper Sec 2.3.3) — the expensive
        #: verb the CommitPolicy exists to keep honest online.
        self.reconfigure_every = reconfigure_every
        #: max migrations allowed per compaction (legacy knob) — folded into
        #: a simulator-local CommitPolicy override (applied only around this
        #: simulator's verb calls, never mutating the shared engine), so an
        #: over-budget plan is a transactional rollback, not clone-and-restore.
        self.migration_budget = migration_budget
        self._commit_override: Optional[CommitPolicy] = None
        if migration_budget is not None:
            cp = engine.commit_policy
            if cp.mode == "always":
                cp = CommitPolicy(
                    mode="budgeted",
                    move_budget=migration_budget,
                    downtime_budget_seconds=None,
                )
            else:
                cp = dataclasses.replace(cp, move_budget=migration_budget)
            self._commit_override = cp
        #: end of the currently-open migration window (simulated clock).
        self._busy_until = 0.0
        #: cached (registry, gauges) for the per-event fleet-health gauges
        #: — registry lookups are label-canonicalizing dict probes, too
        #: slow for the hot event loop.
        self._gauge_cache: Optional[tuple] = None

    # -- metric integration over time --------------------------------------
    def _sample(self) -> Tuple[int, int, int, float]:
        used = self.state.used_gpus()
        cmp_waste = sum(g.compute_waste() for g in used)
        mem_waste = sum(g.memory_waste() for g in used)
        total_mem = sum(g.device.n_memory_slices for g in self.state.gpus.values())
        used_mem = sum(g.used_memory_slices() for g in used)
        return len(used), cmp_waste, mem_waste, used_mem / max(total_mem, 1)

    def _events_with_compactions(self, trace: Trace):
        """Merge the trace with periodic compact/reconfigure triggers."""
        periodic = [
            (period, kind)
            for period, kind in (
                (self.compact_every, "compact"),
                (self.reconfigure_every, "reconfigure"),
            )
            if period
        ]
        if not periodic:
            yield from trace.events
            return
        pending = sorted((period, period, kind) for period, kind in periodic)

        def _due(until: float):
            while pending and pending[0][0] <= until:
                t, period, kind = pending.pop(0)
                yield Event(time=t, kind=kind)
                nxt = (t + period, period, kind)
                lo = 0
                while lo < len(pending) and pending[lo][0] <= nxt[0]:
                    lo += 1
                pending.insert(lo, nxt)

        for ev in trace.events:
            yield from _due(ev.time)
            yield ev
        while pending and pending[0][0] < trace.horizon:
            yield from _due(pending[0][0])

    def run(self, trace: Trace) -> TraceStats:
        stats = TraceStats(
            policy=self.engine.policy_name,
            horizon=trace.horizon,
            time_avg_gpus_used=0.0,
            time_avg_compute_waste=0.0,
            time_avg_memory_waste=0.0,
            time_avg_mem_occupancy=0.0,
            peak_gpus_used=0,
        )
        acc = np.zeros(4)  # integrals of the _sample() tuple
        t_prev = 0.0
        tel = get_telemetry()
        last_t = 0.0  # when the fleet last changed (gauge timestamps)
        self._horizon = trace.horizon
        events = self._events_with_compactions(trace)
        if self.faults is not None:
            events = heapq.merge(
                events,
                self.faults.schedule(self.state, trace.horizon),
                key=lambda e: e.time,
            )
        for ev in events:
            sample = self._sample()
            if tel.enabled:
                # The pre-event sample describes the fleet since the LAST
                # event — record it there, reusing the scan the
                # time-averaged stats already paid for.
                self._record_sample_gauges(tel, last_t, sample)
            last_t = ev.time
            # Integration is clamped to [0, horizon]: an event past the
            # horizon still mutates state (the replica really departs) but
            # contributes no weight, so the final partial interval is counted
            # exactly once for every time-averaged counter.
            t_now = min(ev.time, trace.horizon)
            if t_now > t_prev:
                acc += np.array(sample) * (t_now - t_prev)
                t_prev = t_now
            stats.peak_gpus_used = max(stats.peak_gpus_used, sample[0])
            if ev.kind == "arrival":
                self._handle_arrival(ev, stats)
            elif ev.kind == "departure":
                self._handle_departure(ev, stats)
            elif ev.kind in ("compact", "reconfigure"):
                self._handle_plan_verb(ev.kind, stats, ev.time)
            elif ev.kind in _FAULT_EVENT_KINDS:
                self._handle_fault(ev, stats, ev.time)
            else:  # pragma: no cover
                raise ValueError(f"unknown event kind {ev.kind!r}")
        if self.faults is not None:
            self._finalize_faults(stats, trace.horizon)
        sample = self._sample()
        if tel.enabled:
            self._record_sample_gauges(tel, trace.horizon, sample)
        acc += np.array(sample) * max(trace.horizon - t_prev, 0.0)
        stats.peak_gpus_used = max(stats.peak_gpus_used, sample[0])
        h = max(trace.horizon, 1e-9)
        (
            stats.time_avg_gpus_used,
            stats.time_avg_compute_waste,
            stats.time_avg_memory_waste,
            stats.time_avg_mem_occupancy,
        ) = (acc / h).tolist()
        return stats

    def _handle_arrival(self, ev: Event, stats: TraceStats) -> None:
        stats.n_arrived += len(ev.workloads)
        batch = list(ev.workloads)
        if self.faults is not None and batch:
            # A whole device kind can be down mid-incident; arrivals routed
            # to it are rejections, not routing errors.
            kinds = {
                g.device.name for g in self.state.gpus.values() if g.schedulable
            }
            routable = [
                w for w in batch if not w.device_kind or w.device_kind in kinds
            ]
            stats.n_rejected += len(batch) - len(routable)
            batch = routable
            if not batch:
                return
        res = self.engine.deploy(self.state, batch)
        stats.engine_seconds += res.seconds
        rejected = {w.wid for w in res.pending}
        stats.n_rejected += len(rejected)
        stats.n_placed += len(batch) - len(rejected)
        # Rejected replicas leave the system (no admission queue — the online
        # analogue of the paper's "pending" metric).
        for wid in rejected:
            self.state.workloads.pop(wid, None)

    def _handle_departure(self, ev: Event, stats: TraceStats) -> None:
        for wid in ev.wids:
            if wid in self._fault_evicted:
                # Ghost departure: a fault already evicted this workload.
                # Its lifetime ends here either way — stop trying to recover
                # it, bump the counter, and touch no occupancy caches.
                self._ghost_departure(wid, stats)
                continue
            gid = self.state.gpu_of(wid)
            if gid is not None:
                self.state.gpus[gid].remove(wid)
                stats.n_departed += 1
                self._fleet_changed()
            self.state.workloads.pop(wid, None)
        if self._recovery_queue:
            # Departures free capacity: retry pending recoveries.
            self._recover(ev.time, stats)

    def _handle_plan_verb(self, verb: str, stats: TraceStats, now: float) -> None:
        if verb not in self.engine.policy.supports:
            return
        tel = get_telemetry()
        if now < self._busy_until:
            # A previous plan's waves/drains still occupy the fleet.
            if verb == "compact":
                stats.n_compactions_deferred += 1
            else:
                stats.n_reconfigures_deferred += 1
            tel.tracer.event("verb_deferred", time=now, verb=verb,
                             busy_until=self._busy_until)
            return
        saved = self.engine.commit_policy
        if self._commit_override is not None:
            self.engine.commit_policy = self._commit_override
        try:
            res = getattr(self.engine, verb)(self.state)
        finally:
            self.engine.commit_policy = saved
        stats.engine_seconds += res.seconds
        if not res.committed:
            # Plan rejected by the CommitPolicy -> transactional rollback
            # already restored the layout; nothing moved.
            if verb == "compact":
                stats.n_compactions_skipped += 1
            stats.n_plans_rejected += 1
            term = res.decision.term or "unknown"
            stats.plan_rejections[term] = stats.plan_rejections.get(term, 0) + 1
            stats.last_rejection_reason = res.decision.reason
            tel.tracer.event("plan_rejected", time=now, verb=verb, term=term,
                             reason=res.decision.reason,
                             shortfall=res.decision.shortfall)
            return
        if verb == "compact":
            stats.n_compactions += 1
        else:
            stats.n_reconfigures += 1
        # Baseline reconfigure replays may fail to re-place a workload
        # (measured Sec-5.2.3 behavior): it leaves the system, like a
        # rejected arrival.
        for w in res.pending:
            self.state.workloads.pop(w.wid, None)
            stats.n_rejected += 1
        stats.n_migrations += res.plan.n_migrations if res.plan else 0
        if res.cost is not None and res.cost.n_moves:
            stats.bytes_moved += res.cost.total_bytes
            stats.disruption_seconds += res.cost.downtime_seconds
            stats.migration_window_seconds += res.cost.duration_seconds
            self._busy_until = now + res.cost.duration_seconds
            if tel.enabled:
                tel.tracer.event(
                    "migration_window", time=now,
                    duration=res.cost.duration_seconds, verb=verb,
                    n_moves=res.plan.n_migrations if res.plan else 0,
                    total_bytes=res.cost.total_bytes,
                    downtime_seconds=res.cost.downtime_seconds,
                )
                tel.metrics.counter(
                    "bytes_moved_total", "bytes moved by committed plans",
                ).inc(float(res.cost.total_bytes), t=now)
        if tel.enabled:
            self._record_fleet_gauges(tel, now)
        if self._recovery_queue:
            # A committed repack may have made room: retry pending recoveries.
            self._recover(now, stats)

    # -- fault injection & recovery -----------------------------------------
    def _fleet_changed(self) -> None:
        """Placement-mutation hook (DemandSimulator dirties its cache)."""

    def _handle_fault(self, ev: FaultEvent, stats: TraceStats, now: float) -> None:
        tel = get_telemetry()
        gpu = self.state.gpus.get(ev.gid)
        if gpu is None:
            stats.n_fault_noops += 1
            return
        if ev.kind == "repair":
            if gpu.health == "healthy":
                stats.n_fault_noops += 1  # duplicate/stale repair
                return
            self._accrue_lost(stats, now)
            self._lost_units -= self._unit_frac.pop(ev.gid, 0.0)
            self.state.set_health(ev.gid, "healthy")
            stats.n_repairs += 1
            tel.tracer.event("repair", time=now, gid=ev.gid, spec=ev.spec)
            self._recover(now, stats)
            self._update_brownout(now, stats)
            return
        if gpu.health != "healthy":
            # Overlapping fault on an already-down target: no-op with a
            # counter bump (its capacity loss is already accounted).
            stats.n_fault_noops += 1
            return
        self._accrue_lost(stats, now)
        victims = list(gpu.placements)
        frac = 1.0
        if ev.kind == "slice_failure":
            # Only the placement covering the dead memory position dies; the
            # GPU is quarantined (degraded) but survivors keep serving.
            occ = gpu.memory_occupancy()
            idx = ev.index % gpu.device.n_memory_slices
            dead_wid = occ[idx]
            victims = [pl for pl in victims if pl.wid == dead_wid]
            frac = 1.0 / gpu.device.n_memory_slices
        self._unit_frac[ev.gid] = frac
        self._lost_units += frac
        self.state.set_health(ev.gid, _HEALTH_FOR[ev.kind])
        counter = _FAULT_COUNTERS[ev.kind]
        setattr(stats, counter, getattr(stats, counter) + 1)
        tel.tracer.event("fault", time=now, kind=ev.kind, gid=ev.gid,
                         n_evicted=len(victims), spec=ev.spec)
        if tel.enabled:
            tel.metrics.counter(
                "failures_total", "injected fault events by kind",
                labels={"kind": ev.kind},
            ).inc(t=now)
        evicted: List[Workload] = []
        for pl in victims:
            w = self.state.workloads.get(pl.wid)
            self.state.remove(pl.wid, ev.gid)
            self.state.forget_workload(pl.wid)
            if w is not None:
                evicted.append(w)
        self._fleet_changed()
        if evicted:
            stats.n_fault_evictions += len(evicted)
            self._fault_evicted.update(w.wid for w in evicted)
            self._incidents.append(
                _Incident(t0=now, remaining={w.wid for w in evicted})
            )
            self._on_fault_evicted(evicted, now, stats)
            self._recovery_queue.extend(evicted)
        self._recover(now, stats)
        self._update_brownout(now, stats)

    def _recover(self, now: float, stats: TraceStats) -> None:
        """Re-place evicted replicas through the engine (CommitPolicy-gated
        deploy; escalated emergency verbs if the free space cannot host them)."""
        if not self._recovery_queue:
            return
        healthy_kinds = {
            g.device.name for g in self.state.gpus.values() if g.schedulable
        }
        if not healthy_kinds:
            return  # nothing to place on; retried at the next repair
        batch = [
            w for w in self._recovery_queue
            if not w.device_kind or w.device_kind in healthy_kinds
        ]
        if not batch:
            return
        tel = get_telemetry()
        with tel.tracer.span("recover") as sp:
            res = self.engine.deploy(self.state, batch)
            stats.engine_seconds += res.seconds
            pending = {w.wid for w in res.pending}
            for wid in pending:
                self.state.workloads.pop(wid, None)  # stays queued, unregistered
            if pending:
                pending = self._escalate_recovery(batch, pending, now, stats)
            placed = [w for w in batch if w.wid not in pending]
            placed_wids = {w.wid for w in placed}
            self._recovery_queue = [
                w for w in self._recovery_queue if w.wid not in placed_wids
            ]
            self._fleet_changed()
            ready = self._on_recovered(placed, now, stats)
            for w in placed:
                self._complete_recovery(w.wid, ready.get(w.wid, now), stats)
            if tel.enabled:
                sp.set(sim_time=now, n_placed=len(placed),
                       n_pending=len(pending))
        self._update_brownout(now, stats)

    def _escalate_recovery(
        self, batch: List[Workload], pending: set, now: float, stats: TraceStats
    ) -> set:
        """Free space can't host the evicted replicas: swap in the commit
        policy's emergency tier, make room with compact/reconfigure, retry."""
        esc = self.engine.commit_policy.escalate()
        if esc is None:
            return pending  # emergency tier disabled ("gated")
        tel = get_telemetry()
        saved = self.engine.commit_policy
        self.engine.commit_policy = esc
        try:
            for verb in ("compact", "reconfigure"):
                if not pending:
                    break
                if verb not in self.engine.policy.supports:
                    continue
                res = getattr(self.engine, verb)(self.state)
                stats.engine_seconds += res.seconds
                if not res.committed:
                    continue
                stats.n_emergency_commits += 1
                tel.tracer.event("emergency_commit", time=now, verb=verb)
                # Emergency repacks pay real disruption: account it exactly
                # like a committed periodic plan verb.
                for w in res.pending:
                    self.state.workloads.pop(w.wid, None)
                    stats.n_rejected += 1
                stats.n_migrations += res.plan.n_migrations if res.plan else 0
                if res.cost is not None and res.cost.n_moves:
                    stats.bytes_moved += res.cost.total_bytes
                    stats.disruption_seconds += res.cost.downtime_seconds
                    stats.migration_window_seconds += res.cost.duration_seconds
                    self._busy_until = max(
                        self._busy_until, now + res.cost.duration_seconds
                    )
                self._sweep_ghosts(now, stats)
                retry = [w for w in batch if w.wid in pending]
                r2 = self.engine.deploy(self.state, retry)
                stats.engine_seconds += r2.seconds
                pending = {w.wid for w in r2.pending}
                for wid in pending:
                    self.state.workloads.pop(wid, None)
        finally:
            self.engine.commit_policy = saved
        return pending

    def _complete_recovery(self, wid: str, at: float, stats: TraceStats) -> None:
        """Mark one evicted replica re-placed; close its incident when the
        last one lands (recovery-time-to-full-capacity accounting)."""
        self._fault_evicted.discard(wid)
        stats.n_fault_recovered += 1
        for inc in self._incidents:
            if wid in inc.remaining:
                inc.remaining.discard(wid)
                inc.done_at = max(inc.done_at, at)
                if not inc.remaining and not inc.recorded:
                    inc.recorded = True
                    dt = max(inc.done_at - inc.t0, 0.0)
                    stats.recovery_seconds_total += dt
                    stats.recovery_seconds_max = max(
                        stats.recovery_seconds_max, dt
                    )
                    tel = get_telemetry()
                    if tel.enabled:
                        tel.metrics.histogram(
                            "recovery_seconds",
                            "fault to full re-placement of its evictions",
                        ).observe(dt)
                        tel.tracer.event("recovered", time=at, t0=inc.t0,
                                         seconds=dt)
                break

    def _ghost_departure(self, wid: str, stats: TraceStats) -> None:
        stats.n_ghost_departures += 1
        self._fault_evicted.discard(wid)
        self._recovery_queue = [
            w for w in self._recovery_queue if w.wid != wid
        ]
        for inc in self._incidents:
            # The workload's lifetime ended before recovery: it no longer
            # holds its incident open (no recovery time is recorded for
            # incidents fully resolved by departures).
            inc.remaining.discard(wid)

    def _on_fault_evicted(
        self, evicted: List[Workload], now: float, stats: TraceStats
    ) -> None:
        """Hook: demand layer requeues the evictions' in-flight requests."""

    def _on_recovered(
        self, placed: List[Workload], now: float, stats: TraceStats
    ) -> Dict[str, float]:
        """Hook: demand layer re-creates replicas; returns wid -> ready-at
        (cold-restore delay).  Base: placements serve immediately."""
        return {}

    def _sweep_ghosts(self, now: float, stats: TraceStats) -> None:
        """Hook: demand layer drops replicas evicted by emergency verbs."""

    def _update_brownout(self, now: float, stats: TraceStats) -> None:
        """Hook: demand layer accrues brownout (recovery-pending) time."""

    def _accrue_lost(self, stats: TraceStats, now: float) -> None:
        t = min(now, self._horizon)
        if t > self._lost_mark:
            stats.capacity_lost_gpu_seconds += (
                self._lost_units * (t - self._lost_mark)
            )
            self._lost_mark = t

    def _finalize_faults(self, stats: TraceStats, horizon: float) -> None:
        self._accrue_lost(stats, horizon)
        stats.n_recovery_pending = len(self._fault_evicted)

    def _record_sample_gauges(self, tel, t: float, sample) -> None:
        """Fleet-health time series on the simulated clock, fed from the
        run loop's own per-event :meth:`_sample` — telemetry piggybacks on
        the scan the time-averaged stats already pay for (zero extra
        fleet scans when enabled)."""
        m = tel.metrics
        if self._gauge_cache is None or self._gauge_cache[0] is not m:
            self._gauge_cache = (m, (
                m.gauge("gpus_used", "GPUs hosting at least one workload"),
                m.gauge("compute_waste_slices",
                        "blocked-but-unusable compute slices"),
                m.gauge("memory_waste_slices", "wasted memory slices"),
                m.gauge("mem_occupancy", "used / total fleet memory slices"),
            ))
        g_used, g_cw, g_mw, g_occ = self._gauge_cache[1]
        used, cmp_waste, mem_waste, occupancy = sample
        g_used.set(used, t=t)
        g_cw.set(cmp_waste, t=t)
        g_mw.set(mem_waste, t=t)
        g_occ.set(occupancy, t=t)

    def _record_fleet_gauges(self, tel, now: float) -> None:
        """Gauges that need their own fleet scan (fragmentation) — recorded
        only after the rare plan verbs, not on every arrival/departure."""
        used = self.state.used_gpus()
        tel.metrics.gauge(
            "fragmentation", "mean free-slice fragmentation (Ting et al.)"
        ).set(
            sum(g.fragmentation() for g in used) / len(used) if used else 0.0,
            t=now,
        )


# ---------------------------------------------------------------------------
# demand-driven simulation: requests -> queues -> autoscaler -> engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelServiceSpec:
    """How one served model's replicas are sized and judged online."""

    model: str
    profile_id: int  # default replica partition profile
    device_kind: str = ""  # routing on mixed fleets (Workload.device_kind)
    #: optional right-sizing candidates (profile ids, any order).  When set,
    #: scale-ups pick the smallest profile whose capacity covers the
    #: per-replica load, and steady-state ticks may *resize* (make-before-
    #: break redeploy) one mismatched replica — MISO-style dynamic slicing.
    profile_ladder: Tuple[int, ...] = ()
    #: replicas deployed at t=0 (static baselines set this and no autoscaler).
    initial_replicas: int = 0
    slo: SLO = SLO()
    #: best-effort tier: shed this model's arrivals first (brownout) while
    #: post-failure capacity cannot host the evicted replicas.
    best_effort: bool = False


@dataclasses.dataclass
class _Replica:
    """Runtime state of one autoscaler-managed replica (single-server FIFO)."""

    wid: str
    model: str
    profile_id: int
    device: DeviceModel
    current: Optional[RequestArrival] = None
    busy_until: float = 0.0
    draining: bool = False  # no new requests; removed at next completion


#: sentinel occupying ``_Replica.current`` while a fault-recovered replica
#: cold-restores (weights transfer + resume); cleared by its "warmup" event.
_RESTORING = object()


class DemandSimulator(OnlineSimulator):
    """Closes the loop from request traffic to placement.

    Replays a ``RequestTrace`` as a discrete-event simulation: requests
    queue per model, live replicas serve them (service times from the
    ``PerfModel`` for each replica's actual partition profile), and every
    ``autoscale_every`` seconds the ``Autoscaler`` turns the observed
    offered load / queue depths / SLO attainment into replica targets that
    are applied through the ``PlacementEngine`` — deploys admit, retires
    drain, and any periodic compact/reconfigure still rides the engine's
    plan/score/commit control plane (``CommitPolicy`` gates migrations).

    Each replica serves one request at a time (a G/G/c queue per model);
    TTFT is queue wait + prefill, TPOT the profile's decode pace.  After the
    horizon no new requests arrive and no control ticks fire, but in-flight
    queues drain to completion so every served request is accounted;
    time-averaged metrics integrate over ``[0, horizon]`` only.
    """

    def __init__(
        self,
        state: ClusterState,
        engine: PlacementEngine,
        specs: Sequence[ModelServiceSpec],
        autoscaler: Optional[Autoscaler] = None,
        perf: Optional[PerfModel] = None,
        autoscale_every: float = 5.0,
        compact_every: Optional[float] = None,
        reconfigure_every: Optional[float] = None,
        migration_budget: Optional[int] = None,
        faults: Optional[FaultInjector] = None,
    ):
        super().__init__(
            state,
            engine,
            compact_every=compact_every,
            migration_budget=migration_budget,
            reconfigure_every=reconfigure_every,
            faults=faults,
        )
        #: brownout engages while fault recovery is pending (see
        #: ``_update_brownout``): best-effort models' arrivals are shed.
        self._brownout_since: Optional[float] = None
        self.specs: Dict[str, ModelServiceSpec] = {s.model: s for s in specs}
        self.autoscaler = autoscaler
        self.perf = perf or PerfModel()
        self.autoscale_every = autoscale_every
        self._wid_counter = itertools.count()
        self._reps: Dict[str, Dict[str, _Replica]] = {
            m: {} for m in self.specs
        }
        self._queues: Dict[str, Deque[RequestArrival]] = {
            m: collections.deque() for m in self.specs
        }
        #: per-model counters over the current control window.
        self._win: Dict[str, Dict[str, float]] = {
            m: self._fresh_window() for m in self.specs
        }
        #: running request shapes (capacity estimation; defaults until seen).
        self._shapes: Dict[str, RequestShape] = {
            m: RequestShape() for m in self.specs
        }
        self._arrived: Dict[str, int] = {m: 0 for m in self.specs}
        self._hits: Dict[str, int] = {m: 0 for m in self.specs}
        self._ttfts: List[float] = []
        self._tpots: List[float] = []
        self._last_tick = 0.0
        #: live event heap + tie-break counter (bound for real in run()).
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        #: fleet metrics only change on placement mutations; request/complete
        #: events reuse the cached sample (O(1) vs O(fleet) per event).
        self._fleet_dirty = True
        self._fleet_cache: Tuple[int, int, int, float] = (0, 0, 0, 0.0)

    def _fleet_sample(self) -> Tuple[int, int, int, float]:
        if self._fleet_dirty:
            self._fleet_cache = self._sample()
            self._fleet_dirty = False
        return self._fleet_cache

    @staticmethod
    def _fresh_window() -> Dict[str, float]:
        return {"arrived": 0, "completed": 0, "hits": 0}

    # -- helpers ------------------------------------------------------------
    def _device_for(self, kind: str) -> DeviceModel:
        for gpu in self.state.gpus.values():
            if not kind or gpu.device.name == kind:
                return gpu.device
        raise ValueError(f"no device of kind {kind!r} in the fleet")

    def _mean_lens(self, model: str) -> Tuple[int, int]:
        return self._shapes[model].means()

    def _total_queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _live_replicas(self, model: str) -> List[_Replica]:
        return [r for r in self._reps[model].values() if not r.draining]

    def _target_utilization(self) -> float:
        if self.autoscaler is not None:
            return self.autoscaler.config.target_utilization
        return 0.7

    def _choose_profile(
        self, spec: ModelServiceSpec, offered_rps: float, target: int
    ) -> int:
        """Right-size: smallest ladder profile covering per-replica load."""
        if not spec.profile_ladder:
            return spec.profile_id
        device = self._device_for(spec.device_kind)
        mean_p, mean_d = self._mean_lens(spec.model)
        per_rep = offered_rps / max(target, 1)
        rho = self._target_utilization()
        ladder = sorted(
            spec.profile_ladder,
            key=lambda pid: self.perf.capacity_rps(device, pid, mean_p, mean_d),
        )
        for pid in ladder:
            if self.perf.capacity_rps(device, pid, mean_p, mean_d) * rho >= per_rep:
                return pid
        return ladder[-1]  # even the biggest slice is short: take it

    # -- replica lifecycle --------------------------------------------------
    def _deploy_replicas(
        self, model: str, n: int, profile_id: int, stats: TraceStats
    ) -> List[_Replica]:
        spec = self.specs[model]
        news = [
            Workload(
                wid=f"{model}#a{next(self._wid_counter)}",
                profile_id=profile_id,
                model=model,
                device_kind=spec.device_kind,
            )
            for _ in range(n)
        ]
        res = self.engine.deploy(self.state, news)
        self._fleet_dirty = True
        stats.engine_seconds += res.seconds
        rejected = {w.wid for w in res.pending}
        stats.n_deploy_rejected += len(rejected)
        for wid in rejected:
            self.state.workloads.pop(wid, None)
        placed: List[_Replica] = []
        for w in news:
            if w.wid in rejected:
                continue
            gid = self.state.gpu_of(w.wid)
            rep = _Replica(
                wid=w.wid,
                model=model,
                profile_id=profile_id,
                device=self.state.gpus[gid].device,
            )
            self._reps[model][w.wid] = rep
            placed.append(rep)
        return placed

    def _remove_replica(self, rep: _Replica) -> None:
        self._fleet_dirty = True
        gid = self.state.gpu_of(rep.wid)
        if gid is not None:
            self.state.remove(rep.wid, gid)
        self.state.workloads.pop(rep.wid, None)
        self._reps[rep.model].pop(rep.wid, None)

    def _retire_replicas(self, model: str, n: int, stats: TraceStats) -> None:
        """Idle replicas go now; busy ones drain (removed at completion)."""
        victims = sorted(
            self._live_replicas(model),
            key=lambda r: (r.current is not None, r.wid),
        )[:n]
        for rep in victims:
            stats.n_scale_downs += 1
            if rep.current is None:
                self._remove_replica(rep)
            else:
                rep.draining = True

    # -- request flow -------------------------------------------------------
    def _dispatch(self, model: str, now: float, heap, seq) -> None:
        q = self._queues[model]
        if not q:
            return
        free = sorted(
            (r for r in self._reps[model].values()
             if r.current is None and not r.draining),
            key=lambda r: r.wid,
        )
        for rep in free:
            if not q:
                break
            req = q.popleft()
            prefill_s, decode_s = self.perf.service_seconds(
                rep.device, rep.profile_id, req.prompt_len, req.decode_len
            )
            ttft = (now - req.time) + prefill_s
            tpot = self.perf.tpot_seconds(rep.device, rep.profile_id)
            rep.current = req
            rep.busy_until = now + prefill_s + decode_s
            heapq.heappush(
                heap,
                (rep.busy_until, next(seq), "complete",
                 (rep.wid, model, req, ttft, tpot)),
            )

    def _handle_request(self, req: RequestArrival, now: float,
                        stats: TraceStats, heap, seq) -> None:
        stats.n_requests += 1
        self._arrived[req.model] += 1
        self._shapes[req.model].add(req.prompt_len, req.decode_len)
        self._win[req.model]["arrived"] += 1
        if self._brownout_since is not None and self.specs[req.model].best_effort:
            # Brownout: post-failure capacity can't host the evicted
            # replicas yet — shed best-effort arrivals (they count as
            # arrived-and-missed, so SLO attainment takes the damage).
            stats.n_shed_requests += 1
            return
        self._queues[req.model].append(req)
        self._dispatch(req.model, now, heap, seq)

    def _handle_complete(self, payload, now: float, stats: TraceStats,
                         heap, seq) -> None:
        wid, model, req, ttft, tpot = payload
        rep = self._reps[model].get(wid)
        if rep is None or rep.current is not req:
            return  # stale: the replica was evicted and the request requeued
        rep.current = None
        stats.n_completed += 1
        self._ttfts.append(ttft)
        self._tpots.append(tpot)
        slo = self.specs[model].slo
        hit = ttft <= slo.ttft_seconds and tpot <= slo.tpot_seconds
        self._win[model]["completed"] += 1
        self._win[model]["hits"] += hit
        self._hits[model] += hit
        if rep.draining:
            self._remove_replica(rep)
        else:
            self._dispatch(model, now, heap, seq)

    # -- control tick -------------------------------------------------------
    def _observations(self, interval: float) -> List[ModelLoad]:
        obs: List[ModelLoad] = []
        for model in sorted(self.specs):
            spec = self.specs[model]
            win = self._win[model]
            mean_p, mean_d = self._mean_lens(model)
            live = self._live_replicas(model)
            if live:
                cap = float(np.mean([
                    self.perf.capacity_rps(r.device, r.profile_id, mean_p, mean_d)
                    for r in live
                ]))
            else:
                cap = self.perf.capacity_rps(
                    self._device_for(spec.device_kind), spec.profile_id,
                    mean_p, mean_d,
                )
            if win["completed"]:
                att = win["hits"] / win["completed"]
            else:
                # Nothing finished this window: healthy if nothing waits.
                att = 1.0 if not self._queues[model] else 0.0
            obs.append(ModelLoad(
                model=model,
                offered_rps=win["arrived"] / max(interval, 1e-9),
                capacity_rps=cap,
                replicas=len(live),
                queue_depth=len(self._queues[model]),
                slo_attainment=att,
                slo=spec.slo,
            ))
        return obs

    def _maybe_resize(self, model: str, obs: ModelLoad, now: float,
                      stats: TraceStats, heap, seq) -> None:
        """Make-before-break conversion of ONE mismatched replica per tick."""
        spec = self.specs[model]
        if not spec.profile_ladder or self.autoscaler is None:
            return
        live = self._live_replicas(model)
        if not live:
            return
        want = self._choose_profile(spec, obs.offered_rps, len(live))
        victim = next(
            (r for r in sorted(live, key=lambda r: r.wid)
             if r.profile_id != want and r.current is None),
            None,
        )
        if victim is None:
            return
        if not self._deploy_replicas(model, 1, want, stats):
            return  # replacement did not fit: keep the old slice
        self._remove_replica(victim)
        stats.n_resizes += 1
        self._dispatch(model, now, heap, seq)

    def _autoscale_tick(self, now: float, stats: TraceStats, heap, seq) -> None:
        stats.n_autoscale_ticks += 1
        interval = now - self._last_tick
        self._last_tick = now
        tel = get_telemetry()
        with tel.tracer.span("autoscale_tick") as sp:
            obs_list = self._observations(interval)
            if tel.enabled:
                for obs in obs_list:
                    lbl = {"model": obs.model}
                    tel.metrics.gauge(
                        "queue_depth", "requests waiting per model",
                        labels=lbl,
                    ).set(obs.queue_depth, t=now)
                    tel.metrics.gauge(
                        "slo_attainment", "window SLO attainment per model",
                        labels=lbl,
                    ).set(obs.slo_attainment, t=now)
                    tel.metrics.gauge(
                        "offered_rps", "offered load per model", labels=lbl,
                    ).set(obs.offered_rps, t=now)
                    tel.metrics.gauge(
                        "replicas", "live replicas per model", labels=lbl,
                    ).set(obs.replicas, t=now)
            n_ups = n_downs = 0
            if self.autoscaler is not None:
                for dec, obs in zip(self.autoscaler.tick(now, obs_list), obs_list):
                    spec = self.specs[dec.model]
                    if dec.delta > 0:
                        pid = self._choose_profile(spec, obs.offered_rps, dec.target)
                        placed = self._deploy_replicas(
                            dec.model, dec.delta, pid, stats
                        )
                        stats.n_scale_ups += len(placed)
                        n_ups += len(placed)
                        tel.tracer.event(
                            "autoscale_up", time=now, model=dec.model,
                            delta=dec.delta, placed=len(placed),
                            target=dec.target, profile_id=pid,
                        )
                        self._dispatch(dec.model, now, heap, seq)
                    elif dec.delta < 0:
                        self._retire_replicas(dec.model, -dec.delta, stats)
                        n_downs += -dec.delta
                        tel.tracer.event(
                            "autoscale_down", time=now, model=dec.model,
                            delta=dec.delta, target=dec.target,
                        )
                    else:
                        before_resizes = stats.n_resizes
                        self._maybe_resize(dec.model, obs, now, stats, heap, seq)
                        if stats.n_resizes > before_resizes:
                            tel.tracer.event(
                                "autoscale_resize", time=now, model=dec.model,
                            )
            if tel.enabled:
                sp.set(sim_time=now, n_scale_ups=n_ups, n_scale_downs=n_downs)
                self._record_sample_gauges(tel, now, self._fleet_sample())
                self._record_fleet_gauges(tel, now)
        if self._recovery_queue:
            self._recover(now, stats)
        for model in self._win:
            self._win[model] = self._fresh_window()

    def _handle_plan_verb(self, verb: str, stats: TraceStats, now: float) -> None:
        """Plan verbs may evict replicas (baseline reconfigure replays):
        requeue their in-flight request and forget the ghost."""
        super()._handle_plan_verb(verb, stats, now)
        self._fleet_dirty = True
        self._sweep_ghosts(now, stats)

    # -- fault hooks (demand layer) ------------------------------------------
    def _fleet_changed(self) -> None:
        self._fleet_dirty = True

    def _sweep_ghosts(self, now: float, stats: TraceStats) -> None:
        """Drop replica objects whose workload left the state (plan-verb or
        emergency-verb evictions); requeue their in-flight request."""
        for model, reps in self._reps.items():
            requeued = False
            for wid in [w for w in reps if w not in self.state.workloads]:
                rep = reps.pop(wid)
                if rep.current is not None and rep.current is not _RESTORING:
                    self._queues[model].appendleft(rep.current)
                    stats.n_requeued_requests += 1
                    requeued = True
            if requeued:
                self._dispatch(model, now, self._heap, self._seq)

    def _on_fault_evicted(
        self, evicted: List[Workload], now: float, stats: TraceStats
    ) -> None:
        """A fault killed these replicas: requeue their in-flight requests at
        the FRONT of their model's queue (they have waited longest)."""
        for w in evicted:
            reps = self._reps.get(w.model)
            if reps is None:
                continue
            rep = reps.pop(w.wid, None)
            if (
                rep is not None
                and rep.current is not None
                and rep.current is not _RESTORING
            ):
                self._queues[w.model].appendleft(rep.current)
                stats.n_requeued_requests += 1

    def _recovery_ready_at(self, w: Workload, now: float) -> float:
        """Cold-restore completion: weights stream back over the migration
        cost model's link, then the replica resumes cold."""
        gid = self.state.gpu_of(w.wid)
        device = (
            self.state.gpus[gid].device if gid is not None
            else self._device_for(w.device_kind)
        )
        cm = self.engine.cost_model
        per = cm.bytes_per_memory_slice
        if per is None:
            gb = getattr(device, "mem_per_slice_gb", None)
            per = (int(gb) << 30) if gb else (10 << 30)
        n_bytes = device.profile(w.profile_id).memory_slices * per
        return now + cm.transfer_seconds(n_bytes) + cm.resume_seconds

    def _on_recovered(
        self, placed: List[Workload], now: float, stats: TraceStats
    ) -> Dict[str, float]:
        """Re-create replica objects for re-placed workloads.  Each restores
        cold (a "warmup" event frees it); its incident closes at ready-time,
        so recovery_seconds measures time to SERVING capacity, not placement."""
        ready: Dict[str, float] = {}
        for w in placed:
            if w.model not in self._reps:
                continue
            gid = self.state.gpu_of(w.wid)
            if gid is None:
                continue
            at = self._recovery_ready_at(w, now)
            ready[w.wid] = at
            rep = _Replica(
                wid=w.wid,
                model=w.model,
                profile_id=w.profile_id,
                device=self.state.gpus[gid].device,
            )
            if at > now:
                rep.current = _RESTORING  # type: ignore[assignment]
                rep.busy_until = at
                heapq.heappush(
                    self._heap, (at, next(self._seq), "warmup", (w.wid, w.model))
                )
            self._reps[w.model][w.wid] = rep
        return ready

    def _handle_warmup(self, payload, now: float, stats: TraceStats,
                       heap, seq) -> None:
        wid, model = payload
        rep = self._reps[model].get(wid)
        if rep is None or rep.current is not _RESTORING:
            return  # evicted again (or retired) while restoring
        rep.current = None
        if rep.draining:
            self._remove_replica(rep)
        else:
            self._dispatch(model, now, heap, seq)

    def _update_brownout(self, now: float, stats: TraceStats) -> None:
        active = bool(self._fault_evicted)
        if active and self._brownout_since is None:
            self._brownout_since = now
        elif not active and self._brownout_since is not None:
            t0 = min(self._brownout_since, self._horizon)
            t1 = min(now, self._horizon)
            stats.brownout_seconds += max(t1 - t0, 0.0)
            self._brownout_since = None

    def _finalize_faults(self, stats: TraceStats, horizon: float) -> None:
        super()._finalize_faults(stats, horizon)
        if self._brownout_since is not None:
            stats.brownout_seconds += max(
                horizon - min(self._brownout_since, horizon), 0.0
            )
            self._brownout_since = None

    # -- main loop ----------------------------------------------------------
    def run(self, traffic: RequestTrace) -> TraceStats:  # type: ignore[override]
        unknown = set(r.model for r in traffic.requests) - set(self.specs)
        if unknown:
            raise ValueError(f"traffic for unknown models: {sorted(unknown)}")
        stats = TraceStats(
            policy=self.engine.policy_name,
            horizon=traffic.horizon,
            time_avg_gpus_used=0.0,
            time_avg_compute_waste=0.0,
            time_avg_memory_waste=0.0,
            time_avg_mem_occupancy=0.0,
            peak_gpus_used=0,
        )
        horizon = traffic.horizon
        seq = self._seq = itertools.count()
        heap: List[Tuple[float, int, str, object]] = [
            (r.time, next(seq), "request", r) for r in traffic.requests
        ]
        heapq.heapify(heap)
        self._heap = heap  # plan-verb eviction hook re-dispatches through it
        self._horizon = horizon
        if self.faults is not None:
            for fe in self.faults.schedule(self.state, horizon):
                heapq.heappush(heap, (fe.time, next(seq), "fault", fe))
        periods = {"compact": self.compact_every,
                   "reconfigure": self.reconfigure_every}
        for kind, period in periods.items():
            if period and kind in self.engine.policy.supports:
                heapq.heappush(heap, (period, next(seq), kind, None))
        if self.autoscaler is not None and self.autoscale_every:
            heapq.heappush(
                heap, (self.autoscale_every, next(seq), "autoscale", None)
            )
        for model in sorted(self.specs):
            spec = self.specs[model]
            if spec.initial_replicas:
                self._deploy_replicas(
                    model, spec.initial_replicas, spec.profile_id, stats
                )
        acc = np.zeros(5)  # fleet sample (4) + total queue depth
        t_prev = 0.0
        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            qdepth = self._total_queue_depth()
            sample = self._fleet_sample() + (qdepth,)
            t_now = min(t, horizon)
            if t_now > t_prev:
                acc += np.array(sample) * (t_now - t_prev)
                t_prev = t_now
            stats.peak_gpus_used = max(stats.peak_gpus_used, sample[0])
            stats.peak_queue_depth = max(stats.peak_queue_depth, qdepth)
            if kind == "request":
                self._handle_request(payload, t, stats, heap, seq)
            elif kind == "complete":
                self._handle_complete(payload, t, stats, heap, seq)
            elif kind == "autoscale":
                if t < horizon:
                    self._autoscale_tick(t, stats, heap, seq)
                    nxt = t + self.autoscale_every
                    if nxt < horizon:
                        heapq.heappush(heap, (nxt, next(seq), kind, None))
            elif kind in ("compact", "reconfigure"):
                if t < horizon:
                    self._handle_plan_verb(kind, stats, t)
                    nxt = t + periods[kind]
                    if nxt < horizon:
                        heapq.heappush(heap, (nxt, next(seq), kind, None))
            elif kind == "fault":
                self._handle_fault(payload, stats, t)
            elif kind == "warmup":
                self._handle_warmup(payload, t, stats, heap, seq)
            else:  # pragma: no cover
                raise ValueError(f"unknown demand event kind {kind!r}")
        if self.faults is not None:
            self._finalize_faults(stats, horizon)
        sample = self._fleet_sample() + (self._total_queue_depth(),)
        acc += np.array(sample) * max(horizon - t_prev, 0.0)
        stats.peak_gpus_used = max(stats.peak_gpus_used, sample[0])
        stats.peak_queue_depth = max(stats.peak_queue_depth, sample[4])
        h = max(horizon, 1e-9)
        (
            stats.time_avg_gpus_used,
            stats.time_avg_compute_waste,
            stats.time_avg_memory_waste,
            stats.time_avg_mem_occupancy,
            stats.time_avg_queue_depth,
        ) = (acc / h).tolist()
        stats.n_unserved = self._total_queue_depth()
        for model in sorted(self.specs):
            arrived = self._arrived[model]
            stats.slo_attainment_by_model[model] = (
                self._hits[model] / arrived if arrived else 1.0
            )
        total_arrived = sum(self._arrived.values())
        stats.slo_attainment = (
            sum(self._hits.values()) / total_arrived if total_arrived else 1.0
        )
        if self._ttfts:
            stats.ttft_p50, stats.ttft_p95, stats.ttft_p99 = [
                float(v) for v in np.percentile(self._ttfts, [50, 95, 99])
            ]
            stats.tpot_p50, stats.tpot_p95, stats.tpot_p99 = [
                float(v) for v in np.percentile(self._tpots, [50, 95, 99])
            ]
        return stats
