"""Placement-integrated cluster serving: core/ placement engine <-> engines.
Counterpart of ``repro/serving/cluster.py``.

This is where the paper's contribution becomes the framework's scheduler.
Each *replica* of a served model is a paper "workload"; its partition profile
is derived from the replica's real memory footprint (params + ragged KV cache
for its serving shape) via a device model: by default the H100 80GB's MIG
geometry (``core.profiles.H100_80GB``), where the reference defaults to its
TPU pod-partition model.  Sizing builds the parameter and cache trees on the
``meta`` device, so it allocates nothing.  The ClusterServer then drives the
three paper use cases over the live cluster:

  * ``deploy``      -> initial deployment (Sec 2.3.1)
  * ``compact``     -> compaction (Sec 2.3.2), periodic
  * ``reconfigure`` -> reconfiguration (Sec 2.3.3), maintenance windows

Placement policy is pluggable through ``core.engine.PlacementEngine``: the
Sec-4.2 heuristic (default), the WPM MIP, the fragmentation-aware
``frag_aware`` policy, or the first-fit / load-balanced baselines — the same
approaches the paper benchmarks, now acting on replicas instead of synthetic
workloads.  This layer holds NO policy dispatch of its own; it only
translates replicas <-> workloads and calls engine verbs.  ``fabric``
("auto"/"on"/"off") selects the vectorized fleet-scale fast path
(``core/fabric.py``) for large clusters.

Migration control plane
-----------------------
``compact`` / ``reconfigure`` ride the engine's plan/score/commit path: the
engine prices every plan with per-replica live bytes (bf16 weights + the
live KV cache of any attached engine, via ``kvcache.live_kv_bytes``) and a
``CommitPolicy`` decides whether the saved nodes justify the disruption.
Committed plans are then *executed stepwise* instead of teleporting:
disruptive moves drain their replica's in-flight work first, wave moves copy
state with KV handoff (the live decode cache follows the replica), and
drained replicas resume last — the ``ExecutionReport`` records every step.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Union

import torch

from ..configs import get_config
from ..core.autoscaler import Autoscaler, ModelLoad, ScaleDecision
from ..core.engine import PlacementEngine
from ..core.metrics import PlacementMetrics, evaluate
from ..core.migration import CommitPolicy, MigrationCostModel, MigrationPlan, PlanCost
from ..core.perfmodel import PerfModel
from ..core.profiles import H100_80GB, DeviceModel, Profile
from ..core.state import ClusterState, Workload
from ..core.tpu_profiles import profile_for_chips
from ..core.traffic import RequestShape
from ..models import bundle
from ..obs import get_telemetry
from .kvcache import live_kv_bytes

__all__ = [
    "replica_footprint_bytes",
    "replica_footprint_parts",
    "replica_profile",
    "ClusterServer",
    "DeployReport",
    "PlacementReport",
    "ExecutionReport",
    "MigrationStep",
    "AutoscaleReport",
    "NoReplicaError",
    "StepPolicy",
    "PlanExecutionError",
]


# ---------------------------------------------------------------------------
# faults & execution hardening
# ---------------------------------------------------------------------------
class NoReplicaError(LookupError):
    """``route()`` found no live replica of the model (all failed/retired).

    Callers that cannot wait should catch this; ``submit()`` catches it
    itself and parks the request in the model's backlog until a replica
    comes back (redeploy, repair, or recovery)."""

    def __init__(self, model: str):
        super().__init__(f"no live replicas of {model!r}")
        self.model = model


@dataclasses.dataclass(frozen=True)
class StepPolicy:
    """Retry/timeout envelope for one plan-execution step.

    Steps are synchronous, so ``timeout_seconds`` cannot preempt a stuck
    step — it measures the elapsed wall time after the step returns and
    treats an overrun as a failure (the runtime equivalent gave up on the
    worker and must redo the step elsewhere).  Failures back off
    exponentially from ``backoff_seconds`` up to ``backoff_cap_seconds``.
    """

    timeout_seconds: float = 30.0
    max_attempts: int = 3
    backoff_seconds: float = 0.05
    backoff_cap_seconds: float = 2.0

    def __post_init__(self) -> None:
        if self.max_attempts < 1 or self.timeout_seconds <= 0:
            raise ValueError(f"invalid step policy: {self}")


# ---------------------------------------------------------------------------
# replica sizing: arch -> memory footprint -> partition profile
# ---------------------------------------------------------------------------
def replica_footprint_parts(
    arch: str, max_batch: int = 8, max_len: int = 8192
) -> Tuple[int, int]:
    """(weights bytes, reserved KV-cache bytes) of one serving replica:
    bf16 params + ragged decode cache for (max_batch, max_len), sized on the
    ``meta`` device: a sliding-window ring, MLA's latent cache and an
    encoder-decoder's cross-attention K/V over ``frontend_len`` frames
    included."""
    mb = bundle(get_config(arch))
    params_b = 2 * mb.param_count()  # bf16 weights
    cfg = mb.cfg
    enc_len = cfg.frontend_len if cfg.enc_dec else 0
    cache = mb.model.init_cache(max_batch, max_len, enc_len, ragged=True, device="meta")
    return int(params_b), live_kv_bytes(cache)


#: activation headroom applied on top of weights + KV when sizing partitions.
FOOTPRINT_HEADROOM = 0.2


def replica_footprint_bytes(
    arch: str, max_batch: int = 8, max_len: int = 8192,
    headroom: float = FOOTPRINT_HEADROOM,
) -> int:
    """Serving HBM footprint of one replica: bf16 params + ragged decode
    cache for (max_batch, max_len), plus activation headroom."""
    params_b, cache_b = replica_footprint_parts(arch, max_batch, max_len)
    return int((params_b + cache_b) * (1.0 + headroom))


def replica_profile(
    arch: str,
    max_batch: int = 8,
    max_len: int = 8192,
    device: DeviceModel = H100_80GB,
) -> Profile:
    """Smallest partition whose memory fits one serving replica."""
    return profile_for_chips(replica_footprint_bytes(arch, max_batch, max_len), device)


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MigrationStep:
    """One step of a plan's stepwise execution."""

    kind: str  # "drain" | "copy" | "cutover" | "resume"
    wid: str
    wave: int = -1  # -1 for drain/resume of disruptive moves
    kv_handoff: bool = False  # live decode cache followed the replica


@dataclasses.dataclass
class ExecutionReport:
    """What actually happened when a committed plan was executed."""

    steps: List[MigrationStep]
    drained: List[str]  # replicas that lost in-flight state windows
    handoffs: List[str]  # replicas whose live KV cache moved with them
    bytes_moved: int = 0
    downtime_seconds: float = 0.0
    #: step-machine outcome: did every step land (after retries)?
    completed: bool = True
    failed_step: str = ""  # "" when completed
    n_retries: int = 0  # step attempts beyond the first, summed
    rolled_back: bool = False  # failure undone: state byte-identical to pre-verb
    resumable: bool = False  # failure journaled: ``resume_execution()`` continues


class PlanExecutionError(RuntimeError):
    """A plan step kept failing after its retry budget.

    Carries the execution ``journal`` (keys of every step that DID land,
    in order) and the partial ``report`` so the caller can roll back or
    resume idempotently from the first unfinished step."""

    def __init__(self, step: str, attempts: int, cause: BaseException,
                 journal: List[Tuple[str, str, int]], report: "ExecutionReport"):
        super().__init__(
            f"plan step {step!r} failed after {attempts} attempts: {cause}"
        )
        self.step = step
        self.attempts = attempts
        self.cause = cause
        self.journal = journal
        self.report = report


@dataclasses.dataclass
class DeployReport:
    placed: List[str]
    pending: List[str]
    plan: MigrationPlan
    metrics: PlacementMetrics
    cost: Optional[PlanCost] = None


@dataclasses.dataclass
class AutoscaleReport:
    """One ``ClusterServer.autoscale()`` control tick."""

    decisions: List[ScaleDecision]
    offered_rps: Dict[str, float]
    deployed: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    retired: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    #: scale-up replicas the engine could not place this tick.
    rejected: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def scaled(self) -> bool:
        return bool(self.deployed or self.retired)


@dataclasses.dataclass
class PlacementReport:
    before: PlacementMetrics
    after: PlacementMetrics
    plan: MigrationPlan
    cost: Optional[PlanCost] = None
    committed: bool = True
    execution: Optional[ExecutionReport] = None
    #: replicas a committed baseline-replay reconfigure failed to re-place
    #: (measured Sec-5.2.3 behavior) — fully retired from the server.
    evicted: List[str] = dataclasses.field(default_factory=list)

    @property
    def gpus_saved(self) -> int:
        return self.before.n_gpus - self.after.n_gpus


# ---------------------------------------------------------------------------
# the cluster server
# ---------------------------------------------------------------------------
class ClusterServer:
    """A cluster of partitionable accelerators scheduled by the paper's
    placement engine.  Nodes are H100 80GB GPUs under their MIG geometry by
    default; the class is device-model-agnostic (pass another
    ``DeviceModel``, e.g. ``tpu_profiles.TPU_V5E_POD``, the reference's
    default).  Attached engines run wherever their parameters live: the
    server records placements and binds no engine to a MIG instance.  The
    placement engine's fabric sweeps run on ``fabric_device`` (default
    ``"cuda"``, raising without a GPU; ``"cpu"`` for the host's torch ops,
    None for the numpy sweep)."""

    def __init__(
        self,
        n_nodes: int,
        device: DeviceModel = H100_80GB,
        policy: str = "heuristic",
        mip_time_limit: float = 30.0,
        fabric: str = "auto",
        commit: Union[str, CommitPolicy] = "always",
        cost_model: Optional[MigrationCostModel] = None,
        plan_deploys: bool = True,
        autoscaler: Optional[Autoscaler] = None,
        perf: Optional[PerfModel] = None,
        engine_factory: Optional[Callable[[str, str, str], Any]] = None,
        autoscale_window: float = 30.0,
        step_policy: Optional[StepPolicy] = None,
        on_execution_failure: str = "rollback",
        fabric_device: Optional[Union[str, torch.device]] = "cuda",
    ):
        if on_execution_failure not in ("rollback", "resume"):
            raise ValueError(
                "on_execution_failure must be 'rollback' or 'resume', "
                f"got {on_execution_failure!r}"
            )
        self.device = device
        # plan_deploys=True gives DeployReport a scored plan; turn it off on
        # fleet-scale servers where the per-deploy clone + diff walk would
        # defeat the fabric fast path (DeployReport.plan/cost become None).
        self.engine = PlacementEngine(
            policy,
            time_limit=mip_time_limit,
            fabric=fabric,
            commit=commit,
            cost_model=cost_model,
            plan_deploys=plan_deploys,
            fabric_device=fabric_device,
        )
        self.engine.bytes_for = self._replica_bytes
        self.policy = self.engine.policy_name
        self.mip_time_limit = mip_time_limit
        self.state = ClusterState.homogeneous(n_nodes, device, prefix="node")
        #: wid -> (model name, arch id)
        self.replicas: Dict[str, Tuple[str, str]] = {}
        self._counter = itertools.count()
        self._rr: Dict[str, int] = {}
        #: wid -> attached live Engine (local demos / tests)
        self.engines: Dict[str, Any] = {}
        #: wid -> (weights bytes, reserved KV bytes) for migration pricing
        self._footprints: Dict[str, Tuple[int, int]] = {}
        #: (arch, max_batch, max_len) -> parts, so repeat deploys stay cheap
        self._parts_cache: Dict[Tuple[str, int, int], Tuple[int, int]] = {}
        # -- demand loop (autoscale) ----------------------------------------
        self.autoscaler = autoscaler
        self.perf = perf or PerfModel()
        #: (model, arch, wid) -> live Engine, attached to scale-up replicas.
        self.engine_factory = engine_factory
        self.autoscale_window = autoscale_window
        #: model -> (arch, profile_id) remembered from the first deploy, so
        #: autoscale() knows how to mint more replicas of the model.
        self._model_specs: Dict[str, Tuple[str, Optional[int]]] = {}
        #: model -> recent submit() timestamps (offered-load window).
        self._req_times: Dict[str, Deque[float]] = collections.defaultdict(
            collections.deque
        )
        #: model -> running request shape for capacity estimation.
        self._req_shapes: Dict[str, RequestShape] = {}
        # -- fault tolerance -------------------------------------------------
        self.step_policy = step_policy or StepPolicy()
        #: "rollback": a failed plan execution undoes the verb entirely;
        #: "resume": keep the committed layout + journal and let
        #: ``resume_execution()`` finish the remaining steps.
        self.on_execution_failure = on_execution_failure
        #: step kind -> remaining injected failures (tests / chaos drills).
        self._failpoints: Dict[str, int] = {}
        self._sleep: Callable[[float], None] = time.sleep
        #: (plan, journal) of a partially-executed plan awaiting resume.
        self._pending_plan: Optional[
            Tuple[MigrationPlan, List[Tuple[str, str, int]]]
        ] = None
        #: model -> requests parked by submit() while no replica was live.
        self._backlog: Dict[str, Deque[Any]] = collections.defaultdict(
            collections.deque
        )
        #: fault-evicted wids: a late departure/retire for one is a no-op.
        self._fault_evicted: set = set()
        self.n_ghost_departures = 0

    # -- migration pricing: live bytes per replica --------------------------
    def _replica_bytes(self, wid: str) -> Optional[int]:
        """Weights + live KV bytes of ``wid`` for the migration cost model.

        The weight half comes from the replica's sized footprint; the KV
        half prefers the *live* decode cache of an attached engine (what a
        KV handoff actually copies) over the reservation-sized estimate.
        Returns None for unknown replicas (cost model falls back to the
        partition-sized estimate).
        """
        parts = self._footprints.get(wid)
        if parts is None:
            return None
        weights_b, kv_b = parts
        eng = self.engines.get(wid)
        if eng is not None and getattr(eng, "cache", None) is not None:
            kv_b = live_kv_bytes(eng.cache)
        return weights_b + kv_b

    # ---------------------------------------------------------------- deploy
    def deploy(
        self,
        model: str,
        arch: str,
        n_replicas: int = 1,
        *,
        max_batch: int = 8,
        max_len: int = 8192,
        profile_id: Optional[int] = None,
    ) -> DeployReport:
        """Initial deployment of n_replicas of ``model`` (paper Sec 2.3.1)."""
        parts: Optional[Tuple[int, int]] = None
        if profile_id is None:
            key = (arch, max_batch, max_len)
            parts = self._parts_cache.get(key)
            if parts is None:
                parts = replica_footprint_parts(arch, max_batch, max_len)
                self._parts_cache[key] = parts
            total = int(sum(parts) * (1.0 + FOOTPRINT_HEADROOM))
            profile_id = profile_for_chips(total, self.device).profile_id
        self._model_specs.setdefault(model, (arch, profile_id))
        news = []
        for _ in range(n_replicas):
            wid = f"{model}/r{next(self._counter)}"
            news.append(Workload(wid=wid, profile_id=profile_id, model=model))
            self.replicas[wid] = (model, arch)
            if parts is not None:
                self._footprints[wid] = parts
        res = self.engine.deploy(self.state, news)
        pending = res.pending
        for w in pending:
            del self.replicas[w.wid]
            self._footprints.pop(w.wid, None)
        if self._backlog.get(model):
            self._flush_backlog(model)
        return DeployReport(
            placed=[w.wid for w in news if w not in pending],
            pending=[w.wid for w in pending],
            plan=res.plan,
            metrics=self.metrics(),
            cost=res.cost,
        )

    # ---------------------------------------------------------------- retire
    def retire(self, model: str, n: int = 1) -> List[str]:
        """Remove up to n replicas of ``model`` (scale-down).

        Replicas whose attached engine is idle go first; a busy victim is
        pumped dry before teardown so no in-flight request is lost."""
        candidates = [w for w, (m, _) in self.replicas.items() if m == model]
        candidates.sort(
            key=lambda w: (getattr(self.engines.get(w), "has_work", False), w)
        )
        victims = candidates[:n]
        for wid in victims:
            eng = self.engines.get(wid)
            while eng is not None and getattr(eng, "has_work", False):
                eng.step()
        for wid in victims:
            gid = self.state.gpu_of(wid)
            if gid is not None:
                self.state.gpus[gid].remove(wid)
            self.state.workloads.pop(wid, None)
            self.replicas.pop(wid, None)
            self.engines.pop(wid, None)
            self._footprints.pop(wid, None)
        return victims

    # ----------------------------------------------------------- compaction
    def compact(self) -> PlacementReport:
        """Vacate underutilized nodes (paper Sec 2.3.2); run periodically.

        Note: each policy now compacts with its OWN rule (the engine verb);
        the pre-engine code silently fell back to the Sec-4.2 heuristic for
        non-MIP policies, so baseline policies may pack less tightly here.
        """
        return self._gated_verb("compact")

    # -------------------------------------------------------- reconfiguration
    def reconfigure(self) -> PlacementReport:
        """Optimal re-placement of everything (paper Sec 2.3.3); maintenance."""
        return self._gated_verb("reconfigure")

    def _gated_verb(self, verb: str) -> PlacementReport:
        """Engine plan/score/commit, then stepwise execution of the plan.

        The whole verb runs inside an outer state transaction: the engine's
        own commit splices into it, so when plan *execution* dies mid-step
        with ``on_execution_failure="rollback"`` the fleet is restored
        byte-identical to its pre-verb layout (the committed-but-unexecuted
        placements are undone).  With ``"resume"`` the committed layout and
        the execution journal survive; ``resume_execution()`` continues from
        the first unfinished step.
        """
        committed = False
        execution: Optional[ExecutionReport] = None
        with self.state.transaction() as txn:
            res = getattr(self.engine, verb)(self.state)
            # res.baseline is the engine's own pre-verb snapshot — reuse it
            # for the before/after metrics rather than cloning the fleet
            # twice.
            before_state = res.baseline
            committed = res.committed
            if res.committed and res.plan is not None:
                try:
                    execution = self._execute_plan(res.plan)
                except PlanExecutionError as e:
                    execution = e.report
                    if self.on_execution_failure == "resume":
                        self._pending_plan = (res.plan, list(e.journal))
                        execution.resumable = True
                    else:
                        txn.rollback()
                        execution.rolled_back = True
                        committed = False
        evicted = []
        if committed:
            # A committed baseline-replay reconfigure may fail to re-place
            # some replicas (its adopt removed them): retire them everywhere
            # so no ghost replica lingers in routing/engines/footprints.
            for w in res.pending:
                if w.wid in self._fault_evicted:
                    self.n_ghost_departures += 1
                    self._fault_evicted.discard(w.wid)
                    continue
                if w.wid in self.replicas:
                    evicted.append(w.wid)
                self.state.workloads.pop(w.wid, None)
                self.replicas.pop(w.wid, None)
                self.engines.pop(w.wid, None)
                self._footprints.pop(w.wid, None)
        return PlacementReport(
            before=evaluate(before_state),
            after=evaluate(self.state, before_state),
            plan=res.plan,
            cost=res.cost,
            committed=committed,
            execution=execution,
            evicted=evicted,
        )

    # ------------------------------------------------------- plan execution
    def inject_step_failure(self, kind: str, times: int = 1) -> None:
        """Arm a failpoint: the next ``times`` attempts of any step of
        ``kind`` ("drain" / "copy" / "cutover" / "resume") raise.  Chaos
        drills and tests use this to exercise retry / rollback / resume."""
        if times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        self._failpoints[kind] = self._failpoints.get(kind, 0) + times

    def _maybe_failpoint(self, kind: str) -> None:
        n = self._failpoints.get(kind, 0)
        if n > 0:
            if n == 1:
                del self._failpoints[kind]
            else:
                self._failpoints[kind] = n - 1
            raise RuntimeError(f"injected failure at step {kind!r}")

    def _plan_steps(
        self, plan: MigrationPlan
    ) -> List[Tuple[str, List[Tuple[str, str, int, bool]]]]:
        """Expand a plan into phases of (kind, wid, wave, kv_handoff) steps.

        Order matches the runtime transition: disruptive moves drain their
        replica first, wave moves copy + cut over, drained replicas copy
        weights and resume last, cold.  Step keys ``(kind, wid, wave)`` are
        stable across calls — the execution journal is keyed on them so a
        resumed execution skips exactly the steps that already landed.
        """
        phases: List[Tuple[str, List[Tuple[str, str, int, bool]]]] = []
        phases.append(
            ("drain", [("drain", mv.wid, -1, False) for mv in plan.disruptive])
        )
        for i, wave in enumerate(plan.waves):
            steps: List[Tuple[str, str, int, bool]] = []
            for mv in wave:
                if mv.src_gid is None:
                    continue  # fresh deployment: nothing to copy
                handoff = mv.wid in self.engines
                steps.append(("copy", mv.wid, i, handoff))
                steps.append(("cutover", mv.wid, i, False))
            phases.append((f"copy_wave:{i}", steps))
        resume: List[Tuple[str, str, int, bool]] = []
        for mv in plan.disruptive:
            # drained replicas still transfer their weights (KV went cold
            # with the drain, so no handoff) before the cold resume.
            resume.append(("copy", mv.wid, -1, False))
            resume.append(("resume", mv.wid, -1, False))
        phases.append(("resume", resume))
        return phases

    def _perform_step(self, step: Tuple[str, str, int, bool]) -> None:
        """One step's side effects.  Steps are idempotent: a drain pumps an
        already-dry engine zero times, copy/cutover/resume re-assert
        bookkeeping — a retry or resume may safely redo a step whose first
        attempt died after the work landed."""
        kind, wid, _, _ = step
        if kind == "drain":
            eng = self.engines.get(wid)
            while eng is not None and getattr(eng, "has_work", False):
                eng.step()  # finish in-flight requests before teardown

    def _run_step(self, step: Tuple[str, str, int, bool], tel) -> int:
        """Run one step under the ``StepPolicy`` envelope; returns the
        number of retries spent.  Raises the last failure once the attempt
        budget is exhausted."""
        pol = self.step_policy
        kind = step[0]
        delay = pol.backoff_seconds
        last: Optional[BaseException] = None
        for attempt in range(1, pol.max_attempts + 1):
            t0 = time.monotonic()
            try:
                self._maybe_failpoint(kind)
                self._perform_step(step)
                if time.monotonic() - t0 > pol.timeout_seconds:
                    # Synchronous steps can't be preempted: an overrun is
                    # detected after the fact and treated as a failure (the
                    # runtime gave up on this worker).
                    raise TimeoutError(
                        f"step {kind!r} overran {pol.timeout_seconds}s"
                    )
                return attempt - 1
            except Exception as e:  # noqa: BLE001 - every failure retries
                last = e
                if tel.enabled:
                    tel.metrics.counter(
                        "plan_step_retries_total",
                        "plan-execution step attempts that failed",
                        labels={"kind": kind},
                    ).inc()
                if attempt < pol.max_attempts:
                    self._sleep(min(delay, pol.backoff_cap_seconds))
                    delay *= 2.0
        assert last is not None
        raise last

    def _execute_plan(
        self,
        plan: MigrationPlan,
        completed: Optional[List[Tuple[str, str, int]]] = None,
    ) -> ExecutionReport:
        """Execute a committed plan as a journaled step machine.

        The cluster state already holds the final layout (the engine
        committed it); this walks the *runtime* transition.  Disruptive
        moves drain their replica first (in-flight work on an attached
        engine is pumped to completion — no tokens are lost, but the
        replica's slots go cold).  Wave moves copy state with a cutover; an
        attached engine object stays bound to its wid through the move —
        the live decode cache rides along (KV handoff).  Drained replicas
        resume last, cold.

        Every step runs under the server's ``StepPolicy`` (timeout +
        bounded exponential-backoff retry) and its key is journaled when it
        lands.  ``completed`` (from a prior attempt's journal) skips steps
        that already executed, making resume idempotent.  A step that
        exhausts its budget raises ``PlanExecutionError`` carrying the
        journal and the partial report.
        """
        tel = get_telemetry()
        done = set(completed or ())
        journal: List[Tuple[str, str, int]] = list(completed or ())
        steps: List[MigrationStep] = []
        drained: List[str] = []
        handoffs: List[str] = []
        n_retries = 0
        failure: Optional[Tuple[str, BaseException]] = None
        with tel.tracer.span("execute_plan") as sp:
            for label, phase_steps in self._plan_steps(plan):
                # span names stay "drain" / "copy_wave" / "resume"
                with tel.tracer.span(label.split(":")[0]) as psp:
                    n_landed = 0
                    for st in phase_steps:
                        kind, wid, wave, handoff = st
                        key = (kind, wid, wave)
                        if key in done:
                            continue  # landed in a previous attempt
                        try:
                            n_retries += self._run_step(st, tel)
                        except Exception as e:  # noqa: BLE001
                            failure = (kind, e)
                            break
                        done.add(key)
                        journal.append(key)
                        steps.append(
                            MigrationStep(kind, wid, wave=wave, kv_handoff=handoff)
                        )
                        if kind == "drain":
                            drained.append(wid)
                        if handoff:
                            handoffs.append(wid)
                        n_landed += 1
                    if tel.enabled:
                        psp.set(n_steps=n_landed)
                        if label.startswith("copy_wave"):
                            psp.set(wave=int(label.split(":")[1]))
                if failure is not None:
                    break
            # The engine already priced this exact plan (same state, same
            # bytes_for) when it scored the commit; fresh deployments priced at
            # zero there, so the totals are the executed moves' totals.
            cost = plan.cost
            if cost is None:  # plans from older call sites: price once here
                cost = self.engine.cost_model.price(
                    plan, self.state, bytes_for=self.engine.bytes_for
                )
            bytes_moved = cost.total_bytes
            downtime = cost.downtime_seconds
            if tel.enabled:
                sp.set(n_steps=len(steps), n_waves=len(plan.waves),
                       n_drained=len(drained), n_handoffs=len(handoffs),
                       n_retries=n_retries, completed=failure is None,
                       bytes_moved=bytes_moved, downtime_seconds=downtime)
                tel.metrics.counter(
                    "kv_handoffs_total", "replicas whose live KV moved with them",
                ).inc(float(len(handoffs)))
        report = ExecutionReport(
            steps=steps,
            drained=drained,
            handoffs=handoffs,
            bytes_moved=bytes_moved,
            downtime_seconds=downtime,
            completed=failure is None,
            failed_step=failure[0] if failure else "",
            n_retries=n_retries,
        )
        if failure is not None:
            raise PlanExecutionError(
                step=failure[0],
                attempts=self.step_policy.max_attempts,
                cause=failure[1],
                journal=journal,
                report=report,
            )
        return report

    def resume_execution(self) -> Optional[ExecutionReport]:
        """Finish a plan whose execution died mid-step (``"resume"`` mode).

        Re-runs the pending plan, skipping every journaled step; returns
        the new report, or None when nothing is pending.  If execution
        fails again the (extended) journal is kept for the next attempt.
        """
        if self._pending_plan is None:
            return None
        plan, journal = self._pending_plan
        try:
            report = self._execute_plan(plan, completed=journal)
        except PlanExecutionError as e:
            self._pending_plan = (plan, list(e.journal))
            e.report.resumable = True
            raise
        self._pending_plan = None
        return report

    # ------------------------------------------------------- fault handling
    def fail_node(self, gid: str) -> Dict[str, Any]:
        """A node died: quarantine it, evict its replicas, and re-place
        them through the engine.

        Queued requests on evicted replicas' engines move to their model's
        backlog (requeued, not lost).  If the plain re-deploy cannot fit
        every evicted replica, the commit policy's emergency tier kicks in:
        budgets are lifted and a compact/reconfigure repacks the surviving
        fleet to make room.  Replicas that still don't fit are retired
        (capacity is really gone); their requests stay backlogged for
        ``repair_node`` / a later ``deploy``.
        """
        gpu = self.state.gpus[gid]
        tel = get_telemetry()
        with tel.tracer.span("fail_node") as sp:
            self.state.set_health(gid, "failed")
            victims = [pl.wid for pl in gpu.placements]
            evicted: List[Workload] = []
            models: List[str] = []
            for wid in victims:
                w = self.state.workloads.get(wid)
                eng = self.engines.pop(wid, None)
                if eng is not None and wid in self.replicas:
                    model = self.replicas[wid][0]
                    for req in list(getattr(eng, "queue", ())):
                        self._backlog[model].append(req)
                self.state.remove(wid, gid)
                if w is not None and wid in self.replicas:
                    self.state.forget_workload(wid)
                    evicted.append(w)
                    models.append(self.replicas[wid][0])
            if tel.enabled:
                tel.metrics.counter(
                    "failures_total", "injected/declared node failures",
                    labels={"kind": "gpu_failure"},
                ).inc()
            tel.tracer.event(
                "fault", time=time.time(), kind="gpu_failure", gid=gid,
                n_evicted=len(evicted),
            )
            recovered, lost, emergency = self._replace_evicted(evicted)
            for model in dict.fromkeys(models):
                self._flush_backlog(model)
            if tel.enabled:
                sp.set(gid=gid, n_evicted=len(evicted),
                       n_recovered=len(recovered), n_lost=len(lost),
                       emergency=emergency)
        return {
            "gid": gid,
            "evicted": [w.wid for w in evicted],
            "recovered": recovered,
            "lost": lost,
            "emergency": emergency,
        }

    def _replace_evicted(
        self, evicted: List[Workload]
    ) -> Tuple[List[str], List[str], bool]:
        """Re-place fault-evicted replicas; escalate if they don't fit."""
        if not evicted:
            return [], [], False
        res = self.engine.deploy(self.state, list(evicted))
        pending = {w.wid for w in res.pending}
        emergency = False
        if pending and self.engine.commit_policy.escalate() is not None:
            saved = self.engine.commit_policy
            self.engine.commit_policy = saved.escalate()
            try:
                for verb in ("compact", "reconfigure"):
                    if verb not in self.engine.policy.supports:
                        continue
                    report = self._gated_verb(verb)
                    if report.committed:
                        emergency = True
                        tel = get_telemetry()
                        tel.tracer.event(
                            "emergency_commit", time=time.time(), verb=verb
                        )
                    retry = [
                        self.state.workloads[wid] for wid in sorted(pending)
                        if wid in self.state.workloads
                    ]
                    if not retry:
                        break
                    res = self.engine.deploy(self.state, retry)
                    pending = {w.wid for w in res.pending}
                    if not pending:
                        break
            finally:
                self.engine.commit_policy = saved
        lost = sorted(pending)
        for wid in lost:  # capacity is really gone: retire everywhere
            self.state.workloads.pop(wid, None)
            self.replicas.pop(wid, None)
            self.engines.pop(wid, None)
            self._footprints.pop(wid, None)
            self._fault_evicted.add(wid)
        recovered = [w.wid for w in evicted if w.wid not in pending]
        return recovered, lost, emergency

    def repair_node(self, gid: str) -> None:
        """Return a quarantined node to service and drain any backlog."""
        self.state.set_health(gid, "healthy")
        tel = get_telemetry()
        tel.tracer.event("repair", time=time.time(), gid=gid)
        for model in list(self._backlog):
            if self._backlog[model]:
                self._flush_backlog(model)

    # ---------------------------------------------------------------- serving
    def replicas_of(self, model: str) -> List[str]:
        return [
            w for w, (m, _) in self.replicas.items()
            if m == model and self.state.gpu_of(w) is not None
        ]

    def route(self, model: str) -> str:
        """Round-robin replica choice for an incoming request.

        Raises ``NoReplicaError`` when no replica of ``model`` is placed
        (all failed, evicted, or retired)."""
        reps = sorted(self.replicas_of(model))
        if not reps:
            raise NoReplicaError(model)
        i = self._rr.get(model, 0) % len(reps)
        self._rr[model] = i + 1
        return reps[i]

    def attach_engine(self, wid: str, engine) -> None:
        self.engines[wid] = engine

    def submit(self, model: str, request, now: Optional[float] = None) -> Optional[str]:
        """Route a request to a replica's engine; returns the replica wid.

        Every submit is logged into the model's offered-load window so
        ``autoscale()`` can derive arrival rates; pass ``now`` to drive a
        simulated clock (defaults to wall time).  When no replica is live
        (mid-outage) the request is parked in the model's backlog and
        ``None`` is returned; the backlog drains on the next successful
        ``deploy`` / ``repair_node`` of the model."""
        ts = time.time() if now is None else now
        times = self._req_times[model]
        times.append(ts)
        # keep the log bounded to the window even if autoscale() never runs
        while times and times[0] < ts - self.autoscale_window:
            times.popleft()
        self._req_shapes.setdefault(model, RequestShape()).add(
            len(getattr(request, "prompt", ())),
            int(getattr(request, "max_new_tokens", 0)),
        )
        try:
            wid = self.route(model)
        except NoReplicaError:
            self._backlog[model].append(request)
            tel = get_telemetry()
            if tel.enabled:
                tel.metrics.counter(
                    "backlogged_requests_total",
                    "requests parked while a model had no live replica",
                    labels={"model": model},
                ).inc()
            return None
        if wid in self.engines:
            self.engines[wid].submit(request)
        return wid

    def _flush_backlog(self, model: str) -> int:
        """Re-route parked requests once ``model`` has live replicas again.

        The requests were already logged into the offered-load window at
        their original ``submit()``, so flushing routes them directly."""
        q = self._backlog.get(model)
        n = 0
        while q:
            try:
                wid = self.route(model)
            except NoReplicaError:
                break
            req = q.popleft()
            if wid in self.engines:
                self.engines[wid].submit(req)
            n += 1
        return n

    # -------------------------------------------------------------- autoscale
    def _offered_rps(self, model: str, now: float) -> float:
        """Arrival rate over the trailing ``autoscale_window`` seconds."""
        times = self._req_times[model]
        while times and times[0] < now - self.autoscale_window:
            times.popleft()
        return len(times) / max(self.autoscale_window, 1e-9)

    def _queue_depth(self, model: str) -> int:
        return sum(
            len(getattr(self.engines[w], "queue", ()))
            for w in self.replicas_of(model)
            if w in self.engines
        )

    def autoscale(
        self,
        now: Optional[float] = None,
        attainment: Optional[Dict[str, float]] = None,
    ) -> AutoscaleReport:
        """One control tick of the demand loop over LIVE engines.

        Measures each deployed model's offered load from its recent
        ``submit()`` history, sizes replica capacity with the perf model,
        and applies the ``Autoscaler``'s decisions through ``deploy`` /
        ``retire`` — the same engine-gated paths a human operator would use.
        Newly placed replicas get an engine from ``engine_factory`` when one
        is configured.  ``attainment`` (model -> fraction meeting SLO over
        the caller's window) feeds the controller's slo mode; callers that
        do not measure latency omit it and run target-utilization sizing.
        """
        if self.autoscaler is None:
            raise RuntimeError("ClusterServer built without an autoscaler")
        ts = time.time() if now is None else now
        observations: List[ModelLoad] = []
        for model in sorted(self._model_specs):
            arch, profile_id = self._model_specs[model]
            mean_p, mean_d = self._req_shapes.get(
                model, RequestShape()
            ).means()
            observations.append(ModelLoad(
                model=model,
                offered_rps=self._offered_rps(model, ts),
                capacity_rps=self.perf.capacity_rps(
                    self.device, profile_id, mean_p, mean_d
                ),
                replicas=len(self.replicas_of(model)),
                queue_depth=self._queue_depth(model),
                slo_attainment=(attainment or {}).get(model, 1.0),
            ))
        decisions = self.autoscaler.tick(ts, observations)
        report = AutoscaleReport(
            decisions=decisions,
            offered_rps={o.model: o.offered_rps for o in observations},
        )
        for dec in decisions:
            if dec.delta > 0:
                arch, profile_id = self._model_specs[dec.model]
                rep = self.deploy(
                    dec.model, arch, n_replicas=dec.delta, profile_id=profile_id
                )
                report.deployed[dec.model] = rep.placed
                if rep.pending:
                    report.rejected[dec.model] = len(rep.pending)
                if self.engine_factory is not None:
                    for wid in rep.placed:
                        self.attach_engine(
                            wid, self.engine_factory(dec.model, arch, wid)
                        )
            elif dec.delta < 0:
                report.retired[dec.model] = self.retire(dec.model, -dec.delta)
        return report

    def pump(self, max_steps: int = 10_000) -> int:
        """Drive all attached engines until drained; returns tokens produced."""
        total = 0
        for _ in range(max_steps):
            live = [e for e in self.engines.values() if e.has_work]
            if not live:
                break
            for e in live:
                total += e.step()
        return total

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> PlacementMetrics:
        return evaluate(self.state)

    def utilization(self) -> Dict[str, float]:
        used = self.state.used_gpus()
        if not used:
            return {"compute": 0.0, "memory": 0.0, "nodes_used": 0}
        c = sum(g.used_compute_slices() for g in used)
        m = sum(g.used_memory_slices() for g in used)
        return {
            "compute": c / (len(used) * self.device.n_gpu_slices),
            "memory": m / (len(used) * self.device.n_memory_slices),
            "nodes_used": len(used),
        }
