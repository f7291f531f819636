"""PlacementEngine: every placement approach behind one interface.
Copy of ``repro/core/engine.py``.

The paper evaluates five approaches (first-fit, load-balanced, the Sec-4.2
rule-based heuristic, the WPM MIP, and the beyond-paper pattern solver)
across three use cases (initial deployment, compaction, reconfiguration).
The seed codebase dispatched to them ad hoc from three different layers;
this module is now the single entry point:

    engine = PlacementEngine("rule_based")
    engine.deploy(state, new_workloads)   # Sec 2.3.1
    engine.compact(state)                 # Sec 2.3.2
    engine.reconfigure(state)             # Sec 2.3.3

All verbs mutate ``state`` in place (MIP/pattern results are adopted into
the passed state) and return an ``EngineResult``.  Heterogeneous fleets —
GPUs with different ``DeviceModel``s in one ``ClusterState`` — are handled
here: the engine partitions the cluster by device model, routes each
workload to its compatible group (``Workload.device_kind``), and runs the
policy per group, so the policy implementations stay single-device.

Baseline compaction/reconfiguration replays (paper Sec 5.2.2/5.2.3) used to
live in the benchmark harness; they are policy methods now, built on the
transactional state instead of whole-cluster clones.

Fleet-scale deployments route through the vectorized fabric
(``core/fabric.py``): with ``fabric="auto"`` (default), first_fit /
load_balanced / rule_based deploys on fleets of >= ``FABRIC_AUTO_MIN_GPUS``
GPUs use the batched feasibility sweeps — placement-identical to the
scalar path.  The ``frag_aware`` policy (fragmentation-aware scoring per
Ting et al.) is fabric-native.  ``fabric_device`` says where the fabric's
full sweeps run: a torch device, ``"cuda"`` by default (it raises without a
GPU; ``"cpu"`` runs the same torch ops on the host), as the reference runs
its jitted JAX sweeps on its accelerator; None, asked for explicitly, keeps
them in numpy on the host.

Plan / score / commit
---------------------
``compact`` and ``reconfigure`` no longer mutate blindly: the policy runs
inside a ``ClusterState.transaction()``, the resulting diff is derived as a
``MigrationPlan``, priced by a ``MigrationCostModel`` (bytes to transfer,
downtime seconds, SLO disruption), and committed only if the configured
``CommitPolicy`` says the gains (GPUs saved, wastage removed) justify the
disruption — otherwise the transaction rolls back in O(ops), no clone-and-
restore.  The scored plan, the gains, and the decision ride back on the
``EngineResult`` either way.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

import torch

from ..device import resolve_device
from ..obs import get_telemetry
from . import baselines, heuristic
from .migration import (
    BytesFor,
    CommitDecision,
    CommitPolicy,
    MigrationCostModel,
    MigrationPlan,
    PlanCost,
    PlanGains,
    plan_migration,
)
from .state import ClusterState, Workload

__all__ = [
    "EngineResult",
    "PlacementPolicy",
    "PlacementEngine",
    "get_policy",
    "available_policies",
    "POLICIES",
    "CommitPolicy",
    "MigrationCostModel",
]

VERBS = ("deploy", "compact", "reconfigure")


@dataclasses.dataclass
class EngineResult:
    """Outcome of one engine verb."""

    policy: str
    verb: str
    pending: List[Workload]
    seconds: float
    #: scored migration plan (compact/reconfigure always; deploy only when
    #: the engine was built with ``plan_deploys=True``).
    plan: Optional[MigrationPlan] = None
    cost: Optional[PlanCost] = None
    gains: Optional[PlanGains] = None
    decision: Optional[CommitDecision] = None
    #: False when the CommitPolicy rejected the plan and the state was
    #: rolled back to its pre-verb layout.
    committed: bool = True
    #: the pre-verb snapshot the plan was derived against (set whenever a
    #: plan is) — callers needing before/after metrics reuse it instead of
    #: cloning the fleet a second time.
    baseline: Optional[ClusterState] = None


# ---------------------------------------------------------------------------
# policy interface
# ---------------------------------------------------------------------------
#: fleets at or above this size route deployments through the vectorized
#: fabric (core/fabric.py) when ``fabric="auto"`` — below it, the scalar
#: path's lower constant factors win (measured: at 128 GPUs the fabric is
#: ~1.7x faster for first_fit and ~3x for rule_based; at 64 it can lose).
FABRIC_AUTO_MIN_GPUS = 128


class PlacementPolicy:
    """One placement approach; verbs mutate a *single-device* state in place.

    ``fabric`` selects the vectorized fast path for policies that have one
    (first_fit / load_balanced / rule_based deploys): ``"auto"`` uses it on
    fleets of >= FABRIC_AUTO_MIN_GPUS GPUs, ``"on"`` / ``"off"`` force it.
    The fabric paths are placement-identical to the scalar references.
    ``fabric_device`` is where their full sweeps run: a torch device,
    resolved here, so the default ``"cuda"`` raises without a GPU; None asks
    for the numpy sweep on the host.
    """

    name: str = "abstract"
    supports: Tuple[str, ...] = VERBS

    def __init__(self, time_limit: float = 30.0, fabric: str = "auto",
                 fabric_device: Optional[Union[str, torch.device]] = "cuda"):
        if fabric not in ("auto", "on", "off"):
            raise ValueError(f"fabric must be auto/on/off, got {fabric!r}")
        self.time_limit = time_limit
        self.fabric = fabric
        self.fabric_device = (
            None if fabric_device is None else resolve_device(fabric_device)
        )

    def _use_fabric(self, state: ClusterState) -> bool:
        if self.fabric == "on":
            return True
        if self.fabric == "off":
            return False
        return len(state.gpus) >= FABRIC_AUTO_MIN_GPUS

    def deploy(
        self, state: ClusterState, new_workloads: Sequence[Workload]
    ) -> List[Workload]:
        raise NotImplementedError

    def compact(self, state: ClusterState) -> None:
        raise NotImplementedError

    def reconfigure(self, state: ClusterState) -> List[Workload]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# baseline policies (first-fit / load-balanced)
# ---------------------------------------------------------------------------
def _spot_first_fit(
    state: ClusterState, w: Workload, candidates: Sequence[str]
) -> Optional[Tuple[str, int]]:
    for gid in sorted(candidates):
        idx = baselines._try_place(state.gpus[gid], w, numeric_order=True)
        if idx is not None:
            return gid, idx
    return None


def _spot_load_balanced(
    state: ClusterState, w: Workload, candidates: Sequence[str]
) -> Optional[Tuple[str, int]]:
    ordered = sorted(
        candidates, key=lambda gid: (state.gpus[gid].joint_slice_utilization(), gid)
    )
    for gid in ordered:
        idx = baselines._try_place(state.gpus[gid], w, numeric_order=True)
        if idx is not None:
            return gid, idx
    return None


class _BaselinePolicy(PlacementPolicy):
    """Shared compaction/reconfiguration replay for the two baselines."""

    _spot: Callable = None  # (state, w, candidates) -> (gid, idx) | None
    _deploy: Callable = None
    _fabric_deploy: str = ""  # fabric fast-path function name

    def deploy(self, state, new_workloads):
        if self._fabric_deploy and self._use_fabric(state):
            from . import fabric

            return getattr(fabric, self._fabric_deploy)(
                state, new_workloads, device=self.fabric_device
            )
        return type(self)._deploy(state, new_workloads)

    def compact(self, state):
        """Vacate the least utilized GPU into other allocated GPUs, placing
        per the baseline rule; one-shot migrations only (Sec 5.2.2)."""
        spot = type(self)._spot
        progress = True
        while progress:
            progress = False
            used = sorted(
                state.used_gpus(), key=lambda g: (g.joint_slice_utilization(), g.gid)
            )
            for gpu in used:
                others = [g.gid for g in state.used_gpus() if g.gid != gpu.gid]
                before = {o: state.gpus[o].clone() for o in others}
                with state.transaction() as txn:
                    moves: List[Tuple[str, str, int]] = []
                    ok = True
                    for pl in list(state.gpus[gpu.gid].placements):
                        w = state.workloads[pl.wid]
                        state.remove(pl.wid, gpu.gid)
                        s = spot(state, w, others)
                        if s is None:
                            ok = False
                            break
                        state.place(w.wid, *s)
                        moves.append((w.wid, *s))
                    if ok:
                        # one-shot property: destinations free pre-compaction
                        for wid, dst, idx in moves:
                            prof = state.gpus[dst].device.profile(
                                state.workloads[wid].profile_id
                            )
                            if not before[dst].can_place_at(prof, idx):
                                ok = False
                                break
                    if not ok:
                        txn.rollback()
                if ok:
                    progress = True
                    break

    def reconfigure(self, state):
        """Re-place ALL workloads from scratch with the baseline rule
        (arrival order, indexes from 0 — paper Sec 5.2.3)."""
        from .fabric import replay_fresh_deploy

        return replay_fresh_deploy(state, self.deploy)  # fabric-accel if routed


class FirstFitPolicy(_BaselinePolicy):
    name = "first_fit"
    _spot = staticmethod(_spot_first_fit)
    _deploy = staticmethod(baselines.first_fit)
    _fabric_deploy = "fabric_first_fit"


class LoadBalancedPolicy(_BaselinePolicy):
    name = "load_balanced"
    _spot = staticmethod(_spot_load_balanced)
    _deploy = staticmethod(baselines.load_balanced)
    _fabric_deploy = "fabric_load_balanced"


# ---------------------------------------------------------------------------
# rule-based heuristic (Sec 4.2)
# ---------------------------------------------------------------------------
class RuleBasedPolicy(PlacementPolicy):
    name = "rule_based"

    def deploy(self, state, new_workloads):
        if self._use_fabric(state):
            from . import fabric

            return fabric.fabric_initial_deployment(
                state, new_workloads, device=self.fabric_device
            )
        return heuristic.initial_deployment(state, new_workloads)

    def compact(self, state):
        heuristic.compaction(state)

    def reconfigure(self, state):
        return heuristic.reconfiguration(state)


# ---------------------------------------------------------------------------
# fragmentation-aware policy (beyond-paper; Ting et al. scoring on the fabric)
# ---------------------------------------------------------------------------
class FragAwarePolicy(PlacementPolicy):
    """Fabric-native policy scoring every candidate triple by post-placement
    fragmentation delta + wastage (Ting et al.); runs at any fleet size."""

    name = "frag_aware"

    def deploy(self, state, new_workloads):
        from . import fabric

        return fabric.fabric_frag_aware_deploy(
            state, new_workloads, device=self.fabric_device
        )

    def compact(self, state):
        from . import fabric

        fabric.fabric_frag_aware_compact(state, device=self.fabric_device)

    def reconfigure(self, state):
        from . import fabric

        return fabric.fabric_frag_aware_reconfigure(state, device=self.fabric_device)


# ---------------------------------------------------------------------------
# WPM MIP (Sec 4.1)
# ---------------------------------------------------------------------------
def _adopt(state: ClusterState, solved: ClusterState) -> None:
    """Land a solver-produced layout in ``state`` via the journaled
    diff-apply (no GPUState swaps — engine transactions can undo it)."""
    state.adopt(solved)


class MIPPolicy(PlacementPolicy):
    """WPM with existing placements fixed on deploy (paper 'mip')."""

    name = "mip"
    _joint_deploy = False

    def deploy(self, state, new_workloads):
        from .wpm_mip import solve_wpm

        res = solve_wpm(
            state,
            new_workloads,
            movable=self._joint_deploy,
            allow_reconfig=self._joint_deploy,
            time_limit=self.time_limit,
        )
        _adopt(state, res.state)
        return res.pending

    def compact(self, state):
        from .wpm_mip import solve_wpm

        res = solve_wpm(
            state, (), movable=True, allow_reconfig=True, time_limit=self.time_limit
        )
        _adopt(state, res.state)

    def reconfigure(self, state):
        from .wpm_mip import solve_wpm

        res = solve_wpm(
            state, (), movable=True, allow_reconfig=True, time_limit=self.time_limit
        )
        _adopt(state, res.state)
        return res.pending


class JointMIPPolicy(MIPPolicy):
    """WPM jointly re-placing existing workloads on deploy (paper 'joint_mip')."""

    name = "joint_mip"
    _joint_deploy = True


# ---------------------------------------------------------------------------
# pattern-enumeration exact solver (beyond-paper)
# ---------------------------------------------------------------------------
class PatternsPolicy(PlacementPolicy):
    """Exact for (#GPUs, wastage); re-places everything, so migration cost is
    ignored — reconfiguration-style by construction."""

    name = "patterns"
    supports = ("deploy", "reconfigure")

    def deploy(self, state, new_workloads):
        from .patterns import reconfigure_patterns

        for w in new_workloads:
            state.add_workload(w)
        try:
            res = reconfigure_patterns(
                state, extra_workloads=new_workloads, time_limit=self.time_limit
            )
        except RuntimeError:
            # Not enough GPUs (or ILP infeasible) for the joint re-placement:
            # reject the batch, keep the current layout untouched.
            return list(new_workloads)
        _adopt(state, res.state)
        return []

    def reconfigure(self, state):
        from .patterns import reconfigure_patterns

        res = reconfigure_patterns(state, time_limit=self.time_limit)
        _adopt(state, res.state)
        return []


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
POLICIES: Dict[str, Type[PlacementPolicy]] = {
    p.name: p
    for p in (
        FirstFitPolicy,
        LoadBalancedPolicy,
        RuleBasedPolicy,
        FragAwarePolicy,
        MIPPolicy,
        JointMIPPolicy,
        PatternsPolicy,
    )
}
#: legacy aliases (serving layer historically called the heuristic this)
_ALIASES = {"heuristic": "rule_based"}


def available_policies() -> Tuple[str, ...]:
    return tuple(POLICIES)


def get_policy(
    name: str,
    time_limit: float = 30.0,
    fabric: str = "auto",
    fabric_device: Optional[Union[str, torch.device]] = "cuda",
) -> PlacementPolicy:
    key = _ALIASES.get(name, name)
    if key not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; choose from {available_policies()}")
    return POLICIES[key](
        time_limit=time_limit, fabric=fabric, fabric_device=fabric_device
    )


# ---------------------------------------------------------------------------
# the engine: verbs + heterogeneous-fleet routing
# ---------------------------------------------------------------------------
class PlacementEngine:
    """Single entry point for all placement decisions.

    ``deploy`` / ``compact`` / ``reconfigure`` mutate the passed state in
    place.  On a homogeneous cluster the policy runs directly; on a mixed
    fleet the engine runs it once per device group over a sub-view sharing
    the real ``GPUState`` objects, so results land in the real state.
    """

    def __init__(
        self,
        policy: str = "rule_based",
        time_limit: float = 30.0,
        fabric: str = "auto",
        commit: Union[str, CommitPolicy] = "always",
        cost_model: Optional[MigrationCostModel] = None,
        plan_deploys: bool = False,
        fabric_device: Optional[Union[str, torch.device]] = "cuda",
    ):
        self.policy = get_policy(policy, time_limit, fabric, fabric_device)
        self.commit_policy = (
            commit if isinstance(commit, CommitPolicy) else CommitPolicy(mode=commit)
        )
        self.cost_model = cost_model or MigrationCostModel()
        #: optional wid -> live bytes hook (serving layer: weights + KV).
        self.bytes_for: Optional[BytesFor] = None
        #: derive scored plans for deploys too (off by default: the clone +
        #: diff walk is pure overhead on the fleet-scale arrival hot path).
        self.plan_deploys = plan_deploys

    @property
    def policy_name(self) -> str:
        return self.policy.name

    # -- device grouping ---------------------------------------------------
    @staticmethod
    def _groups(state: ClusterState) -> Dict[str, List[str]]:
        """Schedulable GPUs by device kind.

        Unhealthy GPUs (failed / draining / maintenance / degraded — see
        ``state.HEALTH_STATES``) are excluded here, at the single chokepoint
        every verb routes through, so no policy — scalar, fabric-vectorized,
        or MIP — can land new placements on a quarantined GPU, and plan
        verbs never try to repack placements that survive on a degraded one.
        """
        groups: Dict[str, List[str]] = {}
        for gid in state.ordered_gids():
            gpu = state.gpus[gid]
            if not gpu.schedulable:
                continue
            groups.setdefault(gpu.device.name, []).append(gid)
        return groups

    @staticmethod
    def _subview(state: ClusterState, gids: Sequence[str]) -> ClusterState:
        """A per-group view sharing GPUState objects and the workload dict.

        Subviews are memoized on the parent state (keyed by the gid tuple)
        so that the fabric mirror a fast-path deploy attaches to the view
        survives across engine calls — the online-trace hot path.  On reuse
        the gpu/workload references are re-pointed at the parent's current
        objects; the fabric layer re-syncs by placement content, so wholesale
        GPUState replacement (MIP adoption, budget rollback) stays safe.
        """
        subs = state.__dict__.setdefault("_subviews", {})
        key = tuple(gids)
        sub = subs.get(key)
        if sub is None:
            sub = ClusterState(
                gpus={gid: state.gpus[gid] for gid in gids},
                workloads=state.workloads,
            )
            subs[key] = sub
        else:
            for gid in key:
                sub.gpus[gid] = state.gpus[gid]
            sub.workloads = state.workloads
        # Ops performed through the view journal into the parent's open
        # transaction (shared GPUState objects / workload dict make them
        # undoable from the parent) — the commit-gating rollback path.
        sub.link_journal_parent(state)
        return sub

    def _route(
        self, state: ClusterState, workloads: Sequence[Workload]
    ) -> Dict[str, List[Workload]]:
        """Split workloads across device groups by ``device_kind``."""
        groups = self._groups(state)
        if not groups:  # empty cluster: nothing can host anything
            return {}
        if len(groups) == 1:
            kind = next(iter(groups))
            for w in workloads:
                if w.device_kind and w.device_kind != kind:
                    raise ValueError(
                        f"workload {w.wid} targets {w.device_kind!r}, fleet "
                        f"is all {kind!r}"
                    )
            return {kind: list(workloads)}
        routed: Dict[str, List[Workload]] = {k: [] for k in groups}
        for w in workloads:
            if not w.device_kind:
                raise ValueError(
                    f"workload {w.wid} has no device_kind on a mixed fleet "
                    f"({tuple(groups)})"
                )
            if w.device_kind not in routed:
                raise ValueError(
                    f"workload {w.wid} targets {w.device_kind!r}, fleet has "
                    f"{tuple(groups)}"
                )
            routed[w.device_kind].append(w)
        return routed

    def _per_group(self, state: ClusterState, fn) -> List[Workload]:
        """Run ``fn(sub_state, group_gids)`` per device group, copy back."""
        groups = self._groups(state)
        pending: List[Workload] = []
        for kind, gids in groups.items():
            sub = self._subview(state, gids)
            out = fn(sub, kind)
            # Policies may have replaced GPUState objects (reconfigure/MIP)
            # or even the sub dicts; mirror into the real state.
            for gid in gids:
                state.gpus[gid] = sub.gpus[gid]
            if state.workloads is not sub.workloads:
                state.workloads.update(sub.workloads)
            if out:
                pending.extend(out)
        return pending

    # -- plan scoring ------------------------------------------------------
    @staticmethod
    def _wastage(state: ClusterState) -> int:
        return sum(
            g.compute_waste() + g.memory_waste() for g in state.used_gpus()
        )

    def _score(
        self, before: ClusterState, state: ClusterState
    ) -> Tuple[MigrationPlan, PlanCost, PlanGains, CommitDecision]:
        plan = plan_migration(before, state)
        cost = self.cost_model.price(plan, state, bytes_for=self.bytes_for)
        plan.cost = cost
        gains = PlanGains(
            gpus_saved=len(before.used_gpus()) - len(state.used_gpus()),
            waste_saved=self._wastage(before) - self._wastage(state),
        )
        return plan, cost, gains, self.commit_policy.decide(gains, cost)

    # -- telemetry ---------------------------------------------------------
    def _record_verb(self, tel, res: EngineResult) -> None:
        """Feed one verb outcome into the metrics registry (live only)."""
        m = tel.metrics
        labels = {"verb": res.verb, "policy": res.policy}
        m.histogram(
            "planner_latency_seconds", "wall time of one engine verb",
            labels=labels,
        ).observe(res.seconds)
        m.counter("engine_verbs_total", "engine verb invocations",
                  labels=labels).inc()
        if res.decision is not None:
            which = "plans_committed_total" if res.committed else "plans_rejected_total"
            m.counter(
                which, "commit decisions by verb and deciding term",
                labels={**labels, "term": res.decision.term or "unknown"},
            ).inc()
        if res.cost is not None:
            m.counter("bytes_priced_total", "bytes priced across scored plans",
                      labels=labels).inc(float(res.cost.total_bytes))
        if res.pending:
            m.counter("workloads_pending_total",
                      "workloads a verb failed to place",
                      labels=labels).inc(float(len(res.pending)))

    # -- verbs -------------------------------------------------------------
    def deploy(
        self, state: ClusterState, new_workloads: Sequence[Workload]
    ) -> EngineResult:
        self._check("deploy")
        tel = get_telemetry()
        t0 = time.time()
        with tel.tracer.span("deploy") as sp:
            routed = self._route(state, new_workloads)
            if not routed:  # empty cluster: scalar-policy parity = all pending
                for w in new_workloads:
                    state.add_workload(w)
                res = EngineResult(
                    self.policy.name, "deploy", list(new_workloads),
                    time.time() - t0,
                )
                if tel.enabled:
                    sp.set(policy=self.policy.name, n_workloads=0,
                           n_pending=len(res.pending))
                    self._record_verb(tel, res)
                return res

            def _deploy_group(sub, kind):
                if not routed[kind]:
                    return []  # don't wake solver policies for untouched groups
                return self.policy.deploy(sub, routed[kind])

            before = state.clone() if self.plan_deploys else None
            with tel.tracer.span("plan"):
                pending = self._per_group(state, _deploy_group)
            res = EngineResult(
                self.policy.name, "deploy", pending, time.time() - t0
            )
            if before is not None:
                # Deploys are admissions, not optimizations: score the plan
                # (new placements are wave-0 moves; joint policies may also
                # relocate existing replicas) but never gate the commit on it.
                with tel.tracer.span("score") as ssp:
                    res.plan, res.cost, res.gains, res.decision = self._score(
                        before, state
                    )
                    if tel.enabled:
                        ssp.set(n_moves=res.plan.n_moves,
                                total_bytes=res.cost.total_bytes)
                res.baseline = before
            res.seconds = time.time() - t0
            if tel.enabled:
                sp.set(policy=self.policy.name,
                       n_workloads=len(new_workloads),
                       n_pending=len(res.pending))
                self._record_verb(tel, res)
        return res

    def compact(self, state: ClusterState) -> EngineResult:
        return self._gated_verb(state, "compact", lambda sub: self.policy.compact(sub))

    def reconfigure(self, state: ClusterState) -> EngineResult:
        return self._gated_verb(
            state, "reconfigure", lambda sub: self.policy.reconfigure(sub)
        )

    def _gated_verb(self, state: ClusterState, verb: str, fn) -> EngineResult:
        """Run a mutating verb as plan -> score -> commit.

        The policy mutates inside a transaction (sub-view ops journal to it
        via the parent link); the resulting diff is priced and the
        CommitPolicy decides.  Rejection is a journal rollback — placement
        lists, occupancy caches, and GPUState identities all restored.
        """
        self._check(verb)
        tel = get_telemetry()
        t0 = time.time()
        with tel.tracer.span(verb) as sp:
            before = state.clone()  # plan baseline (placement lists only)
            pending: List[Workload] = []
            with state.transaction() as txn:
                with tel.tracer.span("plan"):
                    pending = self._per_group(state, lambda sub, kind: fn(sub)) or []
                with tel.tracer.span("score") as ssp:
                    plan, cost, gains, decision = self._score(before, state)
                    if tel.enabled:
                        ssp.set(n_moves=plan.n_moves,
                                total_bytes=cost.total_bytes,
                                gpus_saved=gains.gpus_saved,
                                waste_saved=gains.waste_saved)
                if not decision.commit:
                    with tel.tracer.span("rollback") as rsp:
                        txn.rollback()
                        if tel.enabled:
                            rsp.set(reason=decision.reason, term=decision.term)
                    pending = []  # layout kept: nothing was evicted
                else:
                    # Commit = leaving the transaction without rollback; the
                    # span marks the decision so every committed verb has a
                    # complete plan/score/commit tree in the trace.
                    with tel.tracer.span("commit") as csp:
                        if tel.enabled:
                            csp.set(reason=decision.reason, term=decision.term,
                                    n_moves=plan.n_migrations)
            res = EngineResult(
                self.policy.name,
                verb,
                pending,
                time.time() - t0,
                plan=plan,
                cost=cost,
                gains=gains,
                decision=decision,
                committed=decision.commit,
                baseline=before,
            )
            if tel.enabled:
                sp.set(policy=self.policy.name, committed=decision.commit,
                       reason=decision.reason, term=decision.term,
                       n_moves=plan.n_moves,
                       bytes_priced=cost.total_bytes)
                self._record_verb(tel, res)
        return res

    def _check(self, verb: str) -> None:
        if verb not in self.policy.supports:
            raise ValueError(
                f"policy {self.policy.name!r} does not support {verb!r} "
                f"(supports {self.policy.supports})"
            )
