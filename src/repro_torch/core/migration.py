"""Migration planner + cost model (framework component 2, Fig. 1).

Given an initial and a final ClusterState, derive an executable plan:
ordered *waves* of moves where every move in a wave can run simultaneously
(its destination span is free once the previous waves completed).  Moves
whose destinations are free in the initial state form wave 0 — these are the
paper's non-disruptive one-shot migrations.  Cyclic dependencies (A waits on
B waits on A) are broken by marking one move per cycle *disruptive* (the
workload must be drained before redeployment), mirroring the paper's
discussion of Figure 4 -> Figure 5 without free GPUs.

Plans are *priced*, not just counted.  ``MigrationCostModel`` converts every
move into bytes-to-transfer (model weights + live KV-cache footprint when
the serving layer supplies per-workload sizes), estimated downtime seconds
(a short traffic-cutover blackout for wave-parallel copies vs a full
drain -> transfer -> resume for disruptive moves), and an SLO-disruption
scalar weighted by each workload's ``migration_cost``.  ``CommitPolicy``
then decides whether a scored plan's gains (GPUs saved, wastage removed)
justify its disruption — the decision rule behind the engine's
plan/score/commit control plane.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from .state import ClusterState, Placement

__all__ = [
    "Move",
    "MigrationPlan",
    "plan_migration",
    "MoveCost",
    "PlanCost",
    "MigrationCostModel",
    "PlanGains",
    "CommitDecision",
    "CommitPolicy",
    "COMMIT_MODES",
]


@dataclasses.dataclass(frozen=True)
class Move:
    wid: str
    src_gid: Optional[str]  # None for a brand-new workload
    src_index: Optional[int]
    dst_gid: str
    dst_index: int
    profile_id: int
    disruptive: bool = False


@dataclasses.dataclass
class MigrationPlan:
    waves: List[List[Move]]
    disruptive: List[Move]
    #: filled by MigrationCostModel.price() on the engine's scoring path.
    cost: Optional["PlanCost"] = None

    def iter_moves(self) -> Iterator[Move]:
        for wave in self.waves:
            yield from wave
        yield from self.disruptive

    @property
    def n_moves(self) -> int:
        return sum(len(w) for w in self.waves) + len(self.disruptive)

    @property
    def n_migrations(self) -> int:
        """Moves of already-placed workloads (excludes fresh deployments)."""
        return sum(1 for mv in self.iter_moves() if mv.src_gid is not None)

    @property
    def n_sequential(self) -> int:
        """Moves that could not run in wave 0 (paper's sequential metric)."""
        return self.n_moves - (len(self.waves[0]) if self.waves else 0)


def _span(state: ClusterState, gid: str, pl: Placement) -> Set[Tuple[str, int]]:
    device = state.gpus[gid].device
    mem, _ = device.profile(pl.profile_id).span(pl.index, device.n_gpu_slices)
    return {(gid, pos) for pos in mem}


def plan_migration(initial: ClusterState, final: ClusterState) -> MigrationPlan:
    """Topologically order the moves needed to reach ``final`` from ``initial``."""
    moves: Dict[str, Move] = {}
    src_spans: Dict[str, Set[Tuple[str, int]]] = {}
    dst_spans: Dict[str, Set[Tuple[str, int]]] = {}

    for gid, gpu in final.gpus.items():
        for pl in gpu.placements:
            src = initial.placement_of(pl.wid)
            if src is not None:
                src_gid, src_pl = src
                if src_gid == gid and src_pl.index == pl.index:
                    continue  # unmoved
                mv = Move(pl.wid, src_gid, src_pl.index, gid, pl.index, pl.profile_id)
                src_spans[pl.wid] = _span(initial, src_gid, src_pl)
            else:
                mv = Move(pl.wid, None, None, gid, pl.index, pl.profile_id)
                src_spans[pl.wid] = set()
            moves[pl.wid] = mv
            dst_spans[pl.wid] = _span(final, gid, pl)

    # Slices occupied in the initial state by workloads that are NOT moving
    # (and not being removed) permanently block their span.
    moving = set(moves)
    final_wids = {p.wid for g in final.gpus.values() for p in g.placements}
    blocked: Set[Tuple[str, int]] = set()
    for gid, gpu in initial.gpus.items():
        for pl in gpu.placements:
            if pl.wid not in moving and pl.wid in final_wids:
                blocked |= _span(initial, gid, pl)

    # Dependency edges: move a depends on move b iff a's destination overlaps
    # b's initial span (b must vacate before a lands).
    deps: Dict[str, Set[str]] = {w: set() for w in moves}
    for a in moves:
        if dst_spans[a] & blocked:
            # Destination overlaps an immovable placement: infeasible final
            # state; treat as disruptive (should not happen for valid plans).
            pass
        for b in moves:
            if a != b and dst_spans[a] & src_spans[b]:
                deps[a].add(b)

    # Kahn's algorithm into waves; break cycles disruptively.
    waves: List[List[Move]] = []
    disruptive: List[Move] = []
    remaining = dict(deps)
    done: Set[str] = set()
    while remaining:
        ready = sorted(w for w, d in remaining.items() if d <= done)
        if not ready:
            # cycle: evict the workload with the smallest footprint (cheapest
            # to drain) and retry.
            victim = min(
                remaining,
                key=lambda w: (len(dst_spans[w]), w),
            )
            disruptive.append(dataclasses.replace(moves[victim], disruptive=True))
            done.add(victim)
            del remaining[victim]
            continue
        waves.append([moves[w] for w in ready])
        for w in ready:
            done.add(w)
            del remaining[w]
    if not waves:
        waves = [[]]
    return MigrationPlan(waves=waves, disruptive=disruptive)


# ---------------------------------------------------------------------------
# cost model: bytes / downtime / SLO disruption per move and per plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoveCost:
    """Price of one move."""

    wid: str
    bytes: int
    transfer_seconds: float
    downtime_seconds: float
    slo_disruption: float
    disruptive: bool


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Price of a whole plan (sums + per-wave makespans)."""

    total_bytes: int
    downtime_seconds: float  # summed per-workload unavailability
    duration_seconds: float  # wall-clock migration window (waves + drains)
    slo_disruption: float  # migration_cost-weighted downtime
    n_moves: int
    n_disruptive: int
    wave_makespans: Tuple[float, ...] = ()

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["wave_makespans"] = list(self.wave_makespans)
        return d


#: wid -> live bytes (weights + KV) supplied by the serving layer; return
#: None to fall back to the profile-derived estimate.
BytesFor = Callable[[str], Optional[int]]


@dataclasses.dataclass(frozen=True)
class MigrationCostModel:
    """Prices moves in bytes, downtime seconds, and SLO disruption.

    Non-disruptive moves copy state while the source replica keeps serving
    (wave-parallel copies), so their only unavailability is the traffic
    cutover; disruptive moves must drain first, so their downtime covers the
    drain, the transfer itself, and the cold resume.  A wave's *makespan* is
    the slowest transfer in it (copies within a wave run in parallel on
    disjoint links); the plan's duration is the sum of wave makespans plus
    the serialized disruptive drains.
    """

    #: effective copy bandwidth per move, GB/s (NVLink/ICI-class link).
    link_gbps: float = 50.0
    #: live-state bytes per occupied memory slice; set it to override the
    #: device-derived estimate.  None (default) derives from the device's
    #: ``mem_per_slice_gb`` (10 GiB fallback when a device lacks it).
    bytes_per_memory_slice: Optional[int] = None
    #: traffic-switch blackout for a non-disruptive (copied-then-cutover) move.
    cutover_seconds: float = 0.5
    #: drain + partition-teardown lead time before a disruptive move.
    drain_seconds: float = 5.0
    #: cold resume after a disruptive redeploy.
    resume_seconds: float = 1.0
    #: global scale on the SLO-disruption scalar.
    slo_weight: float = 1.0

    # -- per-move ----------------------------------------------------------
    def move_bytes(
        self, move: Move, state: ClusterState, bytes_for: Optional[BytesFor] = None
    ) -> int:
        """Live bytes to transfer for ``move`` (0 for fresh deployments)."""
        if move.src_gid is None:
            return 0  # new workload: weights stream from storage, no live state
        if bytes_for is not None:
            b = bytes_for(move.wid)
            if b is not None:
                return int(b)
        device = state.gpus[move.dst_gid].device
        prof = device.profile(move.profile_id)
        if self.bytes_per_memory_slice is not None:
            per_slice = self.bytes_per_memory_slice
        else:
            gb = getattr(device, "mem_per_slice_gb", None)
            per_slice = (int(gb) << 30) if gb else (10 << 30)
        return prof.memory_slices * per_slice

    def transfer_seconds(self, n_bytes: int) -> float:
        return n_bytes / (self.link_gbps * 1e9)

    def move_cost(
        self, move: Move, state: ClusterState, bytes_for: Optional[BytesFor] = None
    ) -> MoveCost:
        b = self.move_bytes(move, state, bytes_for)
        xfer = self.transfer_seconds(b)
        if move.src_gid is None:
            downtime = 0.0  # fresh deployment: nothing was serving yet
        elif move.disruptive:
            downtime = self.drain_seconds + xfer + self.resume_seconds
        else:
            downtime = self.cutover_seconds
        w = state.workloads.get(move.wid)
        weight = w.migration_cost if w is not None else 1.0
        return MoveCost(
            wid=move.wid,
            bytes=b,
            transfer_seconds=xfer,
            downtime_seconds=downtime,
            slo_disruption=self.slo_weight * weight * downtime,
            disruptive=move.disruptive,
        )

    # -- per-plan ----------------------------------------------------------
    def price(
        self,
        plan: MigrationPlan,
        state: ClusterState,
        bytes_for: Optional[BytesFor] = None,
    ) -> PlanCost:
        """Score ``plan`` against ``state`` (the state holding the workloads
        and destination devices — either endpoint works for pricing)."""
        total_bytes = 0
        downtime = 0.0
        slo = 0.0
        duration = 0.0
        makespans: List[float] = []
        n_moves = 0
        n_disruptive = 0
        for wave in plan.waves:
            span = 0.0
            for mv in wave:
                mc = self.move_cost(mv, state, bytes_for)
                total_bytes += mc.bytes
                downtime += mc.downtime_seconds
                slo += mc.slo_disruption
                if mv.src_gid is not None:
                    span = max(span, mc.transfer_seconds)
                n_moves += 1
            makespans.append(span)
            duration += span
        for mv in plan.disruptive:
            mc = self.move_cost(mv, state, bytes_for)
            total_bytes += mc.bytes
            downtime += mc.downtime_seconds
            slo += mc.slo_disruption
            duration += mc.downtime_seconds  # drains serialize the window
            n_moves += 1
            n_disruptive += 1
        return PlanCost(
            total_bytes=total_bytes,
            downtime_seconds=downtime,
            duration_seconds=duration,
            slo_disruption=slo,
            n_moves=n_moves,
            n_disruptive=n_disruptive,
            wave_makespans=tuple(makespans),
        )


# ---------------------------------------------------------------------------
# commit policy: do the plan's gains justify its disruption?
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanGains:
    """What committing the plan buys, measured before vs after."""

    gpus_saved: int = 0
    waste_saved: int = 0  # compute + memory wastage slices removed

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CommitDecision:
    """The structured verdict of a :class:`CommitPolicy`.

    ``term`` names which gain/budget term decided the outcome and
    ``shortfall`` says by how much it failed (0 for commits), so callers —
    ``EngineResult``, ``TraceStats.plan_rejections``, telemetry — can
    aggregate *why* plans are rejected instead of a bare count:

    * ``"no-op"`` / ``"always"``  — trivially committed
    * ``"moves"``                 — move count over ``move_budget``
    * ``"bytes"``                 — bytes over ``bytes_budget``
    * ``"downtime"``              — downtime over ``downtime_budget_seconds``
    * ``"budgets"``               — budgeted mode, all budgets respected
    * ``"net-benefit"``           — net-positive mode's benefit-vs-price term
    """

    commit: bool
    reason: str
    benefit: float = 0.0
    price: float = 0.0
    #: which term decided (see class docstring).
    term: str = ""
    #: how far the failing term missed (benefit units for ``net-benefit``,
    #: the budgeted quantity's units otherwise); 0.0 when committed.
    shortfall: float = 0.0


COMMIT_MODES = ("always", "net-positive", "budgeted")


@dataclasses.dataclass(frozen=True)
class CommitPolicy:
    """When does a scored plan get committed?

    * ``always``       — unconditional (the pre-control-plane behavior).
    * ``net-positive`` — commit iff the gains, valued in GPU-seconds, exceed
                         the disruption price.  A freed GPU is worth
                         ``gpu_seconds_value`` (roughly: how long it stays
                         free before the next repack), a removed wastage
                         slice ``waste_seconds_value``.  The price is the
                         per-replica SLO disruption plus the fleet-level
                         migration window (wave makespans + drains, weighted
                         by ``window_seconds_weight``) plus an optional
                         network charge per GiB moved.
    * ``budgeted``     — commit iff the plan fits every configured budget
                         (downtime seconds, bytes, move count).
    """

    mode: str = "always"
    #: a freed GPU is only worth the time until churn / the next periodic
    #: repack would re-derive it — tens of seconds at online arrival rates.
    gpu_seconds_value: float = 45.0
    waste_seconds_value: float = 5.0
    window_seconds_weight: float = 1.0
    gib_moved_weight: float = 0.0
    downtime_budget_seconds: Optional[float] = 120.0
    bytes_budget: Optional[int] = None
    move_budget: Optional[int] = None
    #: escalation tier for fault recovery: ``"bypass"`` (default) lets
    #: emergency verbs — re-placing replicas evicted by a failure — run with
    #: gating and budgets lifted (capacity restoration beats disruption
    #: accounting when replicas are DOWN); ``"gated"`` keeps the normal
    #: decision rule even under incident pressure.
    emergency: str = "bypass"

    def __post_init__(self) -> None:
        mode = self.mode.replace("_", "-")
        if mode not in COMMIT_MODES:
            raise ValueError(
                f"commit mode must be one of {COMMIT_MODES}, got {self.mode!r}"
            )
        object.__setattr__(self, "mode", mode)
        if self.emergency not in ("bypass", "gated"):
            raise ValueError(
                f"emergency tier must be 'bypass' or 'gated', "
                f"got {self.emergency!r}"
            )

    def escalate(self) -> Optional["CommitPolicy"]:
        """The emergency tier of this policy, or None if escalation is off.

        Escalation is what the recovery path swaps in around its verbs when
        evicted replicas cannot be re-placed in the free space: an
        always-commit variant with every budget lifted, so a net-negative
        compaction/reconfiguration that MAKES ROOM still commits.  The
        caller restores the normal policy afterwards.
        """
        if self.emergency != "bypass":
            return None
        return dataclasses.replace(
            self,
            mode="always",
            downtime_budget_seconds=None,
            bytes_budget=None,
            move_budget=None,
        )

    def decide(self, gains: PlanGains, cost: PlanCost) -> CommitDecision:
        if cost.n_moves == 0:
            return CommitDecision(True, "no-op plan", term="no-op")
        # The move budget is a hard cap in EVERY mode (it is the legacy
        # ``migration_budget`` contract); the downtime/bytes budgets only
        # bind in ``budgeted`` mode.
        if self.move_budget is not None and cost.n_moves > self.move_budget:
            return CommitDecision(
                False, f"moves {cost.n_moves} > budget {self.move_budget}",
                term="moves", shortfall=float(cost.n_moves - self.move_budget),
            )
        if self.mode == "always":
            return CommitDecision(True, "always-commit", term="always")
        if self.mode == "budgeted":
            if self.bytes_budget is not None and cost.total_bytes > self.bytes_budget:
                return CommitDecision(
                    False, f"bytes {cost.total_bytes} > budget {self.bytes_budget}",
                    term="bytes",
                    shortfall=float(cost.total_bytes - self.bytes_budget),
                )
            if (
                self.downtime_budget_seconds is not None
                and cost.downtime_seconds > self.downtime_budget_seconds
            ):
                return CommitDecision(
                    False,
                    f"downtime {cost.downtime_seconds:.1f}s > "
                    f"budget {self.downtime_budget_seconds:.1f}s",
                    term="downtime",
                    shortfall=cost.downtime_seconds - self.downtime_budget_seconds,
                )
            return CommitDecision(True, "within budgets", term="budgets")
        # net-positive
        benefit = (
            gains.gpus_saved * self.gpu_seconds_value
            + gains.waste_saved * self.waste_seconds_value
        )
        price = (
            cost.slo_disruption
            + self.window_seconds_weight * cost.duration_seconds
            + self.gib_moved_weight * (cost.total_bytes / 2**30)
        )
        if benefit > price:
            return CommitDecision(
                True, f"benefit {benefit:.1f} > disruption {price:.1f}",
                benefit=benefit, price=price, term="net-benefit",
            )
        return CommitDecision(
            False, f"benefit {benefit:.1f} <= disruption {price:.1f}",
            benefit=benefit, price=price, term="net-benefit",
            shortfall=price - benefit,
        )
