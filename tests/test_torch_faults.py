"""The port's fault injector and the simulators' recovery plumbing:
``repro_torch.core.faults`` and the fault paths of
``repro_torch.core.events`` against the reference's.

The injector, health-journal, commit-escalation and simulator cases of the
reference's ``tests/test_faults.py`` run on the port (its ``ClusterServer``
cases run in ``tests/test_torch_cluster.py``).  The same ``FaultSpec``s and
seed give both packages the same schedule, and the same faulted online and
demand runs give equal stats and final states.  The port's engines name the
numpy sweep (``fabric_device=None``): without a device they sweep on the
card.  Every test leaves both packages' telemetry disabled.
"""
import dataclasses

import pytest

from repro import obs as jobs
from repro.core import events as jevents
from repro.core import faults as jfaults
from repro.core import fleetgen as jfleetgen
from repro.core.autoscaler import SLO as JSLO
from repro.core.engine import PlacementEngine as JPlacementEngine
from repro.core.migration import CommitPolicy as JCommitPolicy
from repro.core.profiles import A100_80GB as J_A100
from repro.core.state import ClusterState as JClusterState
from repro.core.traffic import (
    ConstantRate as JConstantRate,
    ModelTraffic as JModelTraffic,
    generate_requests as jgenerate_requests,
)
from repro_torch import obs
from repro_torch.core.autoscaler import SLO
from repro_torch.core.engine import PlacementEngine
from repro_torch.core.events import (
    DemandSimulator,
    Event,
    ModelServiceSpec,
    OnlineSimulator,
    Trace,
    generate_trace,
)
from repro_torch.core.faults import FAULT_KINDS, FaultInjector, FaultSpec
from repro_torch.core.fleetgen import build_fleet
from repro_torch.core.migration import CommitPolicy
from repro_torch.core.profiles import A100_80GB
from repro_torch.core.state import ClusterState, Workload
from repro_torch.core.traffic import ConstantRate, ModelTraffic, generate_requests


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    yield
    obs.disable()
    jobs.disable()


def snap(state):
    """Byte-identity fingerprint of a cluster state (comparable across the
    two packages: plain tuples, no package classes)."""
    return (
        {gid: (tuple(dataclasses.astuple(p) for p in g.placements), g.health)
         for gid, g in state.gpus.items()},
        {wid: dataclasses.astuple(w) for wid, w in state.workloads.items()},
    )


def stats_dict(stats):
    """Stats as a dict, minus wall-clock fields (never deterministic)."""
    d = dataclasses.asdict(stats)
    d.pop("engine_seconds")
    return d


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------
class TestFaultInjector:
    def _fleet(self, n=4):
        return ClusterState.homogeneous(n, A100_80GB)

    def test_schedule_is_deterministic(self):
        specs = [
            FaultSpec("gpu_failure", rate=0.05),
            FaultSpec("node_drain", at=(10.0, 20.0), duration=5.0),
        ]
        fleet = self._fleet()
        a = FaultInjector(specs, seed=3).schedule(fleet, 100.0)
        b = FaultInjector(specs, seed=3).schedule(fleet, 100.0)
        assert a == b
        assert a != FaultInjector(specs, seed=4).schedule(fleet, 100.0)

    def test_substreams_are_independent(self):
        a = FaultSpec("gpu_failure", rate=0.05)
        b = FaultSpec("slice_failure", rate=0.1)
        fleet = self._fleet()
        solo = FaultInjector([a], seed=7).schedule(fleet, 200.0)
        both = FaultInjector([a, b], seed=7).schedule(fleet, 200.0)
        assert [e for e in both if e.spec == "gpu_failure"] == solo

    def test_targets_repairs_and_horizon(self):
        fleet = self._fleet(3)
        events = FaultInjector(
            [FaultSpec("node_drain", at=(5.0, 500.0), duration=7.0, count=2)],
            seed=0,
        ).schedule(fleet, 100.0)
        drains = [e for e in events if e.kind == "node_drain"]
        repairs = [e for e in events if e.kind == "repair"]
        assert len(drains) == 2
        assert len(repairs) == 2
        assert {e.gid for e in events} <= set(fleet.gpus)
        assert all(r.time == pytest.approx(5.0 + 7.0) for r in repairs)
        assert len({d.gid for d in drains}) == 2

    def test_slice_failure_index_in_range(self):
        fleet = self._fleet()
        events = FaultInjector(
            [FaultSpec("slice_failure", at=(1.0, 2.0, 3.0))], seed=1
        ).schedule(fleet, 10.0)
        assert events
        n = A100_80GB.n_memory_slices
        assert all(0 <= e.index < n for e in events)

    def test_empty_and_unknown_gids(self):
        fleet = self._fleet()
        assert FaultInjector([], seed=0).schedule(fleet, 100.0) == []
        events = FaultInjector(
            [FaultSpec("gpu_failure", at=(1.0,), gids=("nope",))], seed=0
        ).schedule(fleet, 10.0)
        assert events == []

    def test_spec_validation(self):
        with pytest.raises(ValueError):
            FaultSpec("meteor_strike")
        with pytest.raises(ValueError):
            FaultSpec("gpu_failure", rate=-1.0)
        with pytest.raises(ValueError):
            FaultSpec("gpu_failure", count=0)


# ---------------------------------------------------------------------------
# state: health marks under the journal
# ---------------------------------------------------------------------------
class TestHealthJournal:
    def test_health_and_forget_roll_back_byte_identical(self):
        state = ClusterState.homogeneous(2, A100_80GB)
        state.add_workload(Workload("w", 9))
        state.place("w", "gpu0", 4)
        before = snap(state)
        with state.transaction() as txn:
            state.remove("w", "gpu0")
            state.forget_workload("w")
            state.set_health("gpu0", "failed")
            assert state.gpus["gpu0"].health == "failed"
            txn.rollback()
        assert snap(state) == before
        state.validate()

    def test_unhealthy_gpu_rejects_new_placements(self):
        state = ClusterState.homogeneous(1, A100_80GB)
        state.set_health("gpu0", "draining")
        prof = A100_80GB.profile(9)
        assert not state.gpus["gpu0"].can_place_at(prof, 4)
        state.set_health("gpu0", "healthy")
        assert state.gpus["gpu0"].can_place_at(prof, 4)

    def test_set_health_validates(self):
        state = ClusterState.homogeneous(1, A100_80GB)
        with pytest.raises(ValueError):
            state.set_health("gpu0", "on-fire")


class TestCommitEscalation:
    def test_bypass_lifts_gating_and_budgets(self):
        cp = CommitPolicy(mode="net-positive", move_budget=1, bytes_budget=10)
        esc = cp.escalate()
        assert esc is not None
        assert esc.mode == "always"
        assert esc.move_budget is None
        assert esc.bytes_budget is None
        assert esc.downtime_budget_seconds is None

    def test_gated_disables_escalation(self):
        assert CommitPolicy(emergency="gated").escalate() is None

    def test_invalid_tier_rejected(self):
        with pytest.raises(ValueError):
            CommitPolicy(emergency="sometimes")


# ---------------------------------------------------------------------------
# OnlineSimulator: eviction, recovery, accounting
# ---------------------------------------------------------------------------
def _arrivals(*workloads, t=1.0):
    return Event(time=t, kind="arrival", workloads=tuple(workloads))


class TestOnlineSimulatorFaults:
    def test_spare_capacity_recovers_immediately(self):
        state = ClusterState.homogeneous(4, A100_80GB)
        sim = OnlineSimulator(
            state,
            PlacementEngine("rule_based", fabric_device=None),
            faults=FaultInjector(
                [FaultSpec("gpu_failure", at=(10.0,), gids=("gpu0",))], seed=0
            ),
        )
        stats = sim.run(Trace(
            events=[_arrivals(Workload("a", 9), Workload("b", 9))],
            horizon=50.0,
        ))
        assert stats.n_gpu_failures == 1
        assert stats.n_fault_evictions == 2
        assert stats.n_fault_recovered == 2
        assert stats.n_recovery_pending == 0
        assert stats.recovery_seconds_max == 0.0
        assert stats.capacity_lost_gpu_seconds == pytest.approx(40.0)
        assert state.gpus["gpu0"].health == "failed"
        assert all(state.gpu_of(w) not in (None, "gpu0") for w in ("a", "b"))
        state.validate()

    def test_full_fleet_recovers_after_repair(self):
        state = ClusterState.homogeneous(2, A100_80GB)
        sim = OnlineSimulator(
            state,
            PlacementEngine("rule_based", fabric_device=None),
            faults=FaultInjector(
                [FaultSpec("gpu_failure", at=(10.0,), duration=20.0, gids=("gpu0",))],
                seed=0,
            ),
        )
        stats = sim.run(Trace(
            events=[_arrivals(*(Workload(f"w{i}", 9) for i in range(4)))],
            horizon=60.0,
        ))
        assert stats.n_fault_evictions == 2
        assert stats.n_repairs == 1
        assert stats.n_fault_recovered == 2
        assert stats.n_recovery_pending == 0
        assert stats.recovery_seconds_max == pytest.approx(20.0)
        assert stats.recovery_seconds_total == pytest.approx(20.0)
        assert stats.capacity_lost_gpu_seconds == pytest.approx(20.0)
        assert state.gpus["gpu0"].health == "healthy"
        state.validate()

    def test_permanent_failure_leaves_recovery_pending(self):
        state = ClusterState.homogeneous(1, A100_80GB)
        sim = OnlineSimulator(
            state,
            PlacementEngine("rule_based", fabric_device=None),
            faults=FaultInjector([FaultSpec("gpu_failure", at=(10.0,))], seed=0),
        )
        stats = sim.run(Trace(events=[_arrivals(Workload("a", 9))], horizon=50.0))
        assert stats.n_fault_evictions == 1
        assert stats.n_fault_recovered == 0
        assert stats.n_recovery_pending == 1
        assert stats.recovery_seconds_total == 0.0
        assert stats.capacity_lost_gpu_seconds == pytest.approx(40.0)

    def test_ghost_departure_noops_with_counter(self):
        state = ClusterState.homogeneous(1, A100_80GB)
        sim = OnlineSimulator(
            state,
            PlacementEngine("rule_based", fabric_device=None),
            faults=FaultInjector([FaultSpec("gpu_failure", at=(10.0,))], seed=0),
        )
        stats = sim.run(Trace(
            events=[
                _arrivals(Workload("a", 9)),
                Event(time=30.0, kind="departure", wids=("a",)),
            ],
            horizon=50.0,
        ))
        assert stats.n_ghost_departures == 1
        assert stats.n_departed == 0
        assert stats.n_recovery_pending == 0

    def test_slice_failure_kills_only_covering_placement(self):
        state = ClusterState.homogeneous(2, A100_80GB)
        for wid, idx in (("lo", 0), ("hi", 4)):
            state.add_workload(Workload(wid, 9))
            state.place(wid, "gpu0", idx)
        sim = OnlineSimulator(
            state,
            PlacementEngine("rule_based", fabric_device=None),
            faults=FaultInjector(
                [FaultSpec("slice_failure", at=(5.0,), gids=("gpu0",))], seed=0
            ),
        )
        stats = sim.run(Trace(events=[], horizon=40.0))
        assert stats.n_slice_failures == 1
        assert stats.n_fault_evictions == 1
        assert stats.n_fault_recovered == 1
        assert state.gpus["gpu0"].health == "degraded"
        assert len(state.gpus["gpu0"].placements) == 1
        assert stats.capacity_lost_gpu_seconds == pytest.approx(
            35.0 / A100_80GB.n_memory_slices
        )
        state.validate()

    def test_overlapping_fault_is_noop(self):
        state = ClusterState.homogeneous(2, A100_80GB)
        sim = OnlineSimulator(
            state,
            PlacementEngine("rule_based", fabric_device=None),
            faults=FaultInjector(
                [FaultSpec("gpu_failure", at=(10.0, 20.0), gids=("gpu0",))], seed=0
            ),
        )
        stats = sim.run(Trace(events=[], horizon=50.0))
        assert stats.n_gpu_failures == 1
        assert stats.n_fault_noops == 1

    def test_disabled_injector_is_byte_identical(self):
        def run(faults):
            fleet = build_fleet([(A100_80GB, 6)])
            trace = generate_trace(11, fleet, horizon=80.0)
            sim = OnlineSimulator(
                fleet, PlacementEngine("rule_based", fabric_device=None), compact_every=20.0,
                faults=faults,
            )
            return stats_dict(sim.run(trace)), snap(fleet)

        a_stats, a_state = run(None)
        b_stats, b_state = run(FaultInjector([]))
        assert a_stats == b_stats
        assert a_state == b_state


# ---------------------------------------------------------------------------
# emergency escalation: recovery must repack to make room
# ---------------------------------------------------------------------------
def _blocked_fleet(cls=ClusterState, device=A100_80GB, workload=Workload):
    """gpu0 carries two 1g.10gb blockers at memory 1 and 4, so no 3g.40gb
    (allowed at 0 or 4) fits without repacking; gpu1 hosts the victim."""
    state = cls.homogeneous(2, device)
    for wid, idx in (("b1", 1), ("b2", 4)):
        state.add_workload(workload(wid, 19))
        state.place(wid, "gpu0", idx)
    state.add_workload(workload("v", 9))
    state.place("v", "gpu1", 4)
    return state


class TestEmergencyEscalation:
    def _run(self, commit):
        state = _blocked_fleet()
        sim = OnlineSimulator(
            state,
            PlacementEngine("heuristic", commit=commit, fabric_device=None),
            faults=FaultInjector(
                [FaultSpec("gpu_failure", at=(10.0,), gids=("gpu1",))], seed=0
            ),
        )
        stats = sim.run(Trace(events=[], horizon=50.0))
        return state, stats

    def test_bypass_repacks_and_recovers(self):
        state, stats = self._run(CommitPolicy(mode="net-positive"))
        assert stats.n_fault_evictions == 1
        assert stats.n_emergency_commits >= 1
        assert stats.n_fault_recovered == 1
        assert stats.n_recovery_pending == 0
        assert state.gpu_of("v") == "gpu0"
        state.validate()

    def test_gated_stays_pending(self):
        state, stats = self._run(CommitPolicy(mode="net-positive", emergency="gated"))
        assert stats.n_emergency_commits == 0
        assert stats.n_fault_recovered == 0
        assert stats.n_recovery_pending == 1
        state.validate()


# ---------------------------------------------------------------------------
# DemandSimulator: requeue, brownout, warmup
# ---------------------------------------------------------------------------
def _demand(faults, horizon=120.0, rate=30.0, n_gpus=2, port=True):
    """The reference test's demand run, through the port's classes or (with
    ``port=False``) the reference's."""
    slo = (SLO if port else JSLO)(ttft_seconds=2.0, tpot_seconds=0.05)
    spec_cls = ModelServiceSpec if port else jevents.ModelServiceSpec
    fleet = (build_fleet if port else jfleetgen.build_fleet)(
        [(A100_80GB if port else J_A100, n_gpus)])
    specs = [
        spec_cls(model="chat", profile_id=9, slo=slo, initial_replicas=3),
        spec_cls(model="bot", profile_id=19, slo=slo, initial_replicas=1, best_effort=True),
    ]
    mt, cr = (ModelTraffic, ConstantRate) if port else (JModelTraffic, JConstantRate)
    traffic = (generate_requests if port else jgenerate_requests)(
        [mt("chat", cr(rate)), mt("bot", cr(2.0))], seed=0, horizon=horizon)
    sim = (DemandSimulator if port else jevents.DemandSimulator)(
        fleet, (PlacementEngine("rule_based", fabric_device=None) if port
                else JPlacementEngine("rule_based")), specs,
        faults=faults)
    stats = sim.run(traffic)
    fleet.validate()
    return fleet, stats


class TestDemandSimulatorFaults:
    def _run(self, faults, horizon=120.0, rate=30.0, n_gpus=2):
        return _demand(faults, horizon, rate, n_gpus)

    def test_eviction_requeues_and_brownout_sheds(self):
        fleet, stats = self._run(FaultInjector(
            [FaultSpec("gpu_failure", at=(30.0,), gids=("a100-0",))], seed=0
        ))
        assert stats.n_gpu_failures == 1
        assert stats.n_fault_evictions >= 1
        assert stats.n_requeued_requests >= 1
        if stats.n_recovery_pending:
            assert stats.brownout_seconds > 0.0
            assert stats.n_shed_requests >= 1
        assert stats.n_requests == (
            stats.n_completed + stats.n_unserved + stats.n_shed_requests
        )

    def test_recovered_replica_restores_cold(self):
        fleet, stats = self._run(
            FaultInjector(
                [FaultSpec("gpu_failure", at=(30.0,), gids=("a100-0",))], seed=0
            ),
            n_gpus=4, rate=5.0,
        )
        assert stats.n_fault_recovered >= 1
        assert stats.n_recovery_pending == 0
        assert stats.recovery_seconds_max > 0.0

    def test_disabled_injector_is_byte_identical(self):
        a_fleet, a = self._run(None, rate=5.0)
        b_fleet, b = self._run(FaultInjector([]), rate=5.0)
        assert stats_dict(a) == stats_dict(b)
        assert snap(a_fleet) == snap(b_fleet)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
SCHEDULE_SPECS = [
    dict(kind="gpu_failure", rate=0.05),
    dict(kind="slice_failure", rate=0.1, duration=15.0),
    dict(kind="node_drain", at=(10.0, 20.0, 500.0), duration=5.0, count=2),
    dict(kind="maintenance_window", at=(40.0,), duration=30.0, gids=("a100-1", "a100-3")),
]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_schedule_equals_the_references(seed):
    """The same specs and seed give both injectors the same events."""
    assert FAULT_KINDS == jfaults.FAULT_KINDS
    fleet = build_fleet([(A100_80GB, 6)])
    jfleet = jfleetgen.build_fleet([(J_A100, 6)])
    got = FaultInjector([FaultSpec(**s) for s in SCHEDULE_SPECS], seed=seed
                        ).schedule(fleet, 200.0)
    want = jfaults.FaultInjector([jfaults.FaultSpec(**s) for s in SCHEDULE_SPECS], seed=seed
                                 ).schedule(jfleet, 200.0)
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert len(got) > 5


@pytest.mark.parametrize("policy,device", [("rule_based", None), ("first_fit", None),
                                           ("frag_aware", None), ("frag_aware", "cpu")])
def test_faulted_online_run_equals_the_references(policy, device):
    """A generated trace with failures, slice faults and a drain, compacted
    every 20 s: equal stats and final states in both packages."""
    specs = [dict(kind="gpu_failure", rate=0.02, duration=25.0),
             dict(kind="slice_failure", at=(15.0, 45.0)),
             dict(kind="node_drain", at=(30.0,), duration=10.0)]
    fleet = build_fleet([(A100_80GB, 6)])
    jfleet = jfleetgen.build_fleet([(J_A100, 6)])
    trace = generate_trace(11, fleet, horizon=80.0)
    jtrace = jevents.generate_trace(11, jfleet, horizon=80.0)
    stats = OnlineSimulator(
        fleet, PlacementEngine(policy, fabric_device=device), compact_every=20.0,
        faults=FaultInjector([FaultSpec(**s) for s in specs], seed=2)).run(trace)
    jstats = jevents.OnlineSimulator(
        jfleet, JPlacementEngine(policy), compact_every=20.0,
        faults=jfaults.FaultInjector([jfaults.FaultSpec(**s) for s in specs], seed=2)
    ).run(jtrace)
    fleet.validate()
    assert stats_dict(stats) == stats_dict(jstats)
    assert snap(fleet) == snap(jfleet)
    assert stats.n_fault_evictions > 0


def test_emergency_escalation_equals_the_references():
    got = _blocked_fleet()
    want = _blocked_fleet(JClusterState, J_A100, jevents.Workload)
    spec = dict(kind="gpu_failure", at=(10.0,), gids=("gpu1",))
    stats = OnlineSimulator(
        got, PlacementEngine("heuristic", commit=CommitPolicy(mode="net-positive"),
                              fabric_device=None),
        faults=FaultInjector([FaultSpec(**spec)], seed=0)).run(Trace(events=[], horizon=50.0))
    jstats = jevents.OnlineSimulator(
        want, JPlacementEngine("heuristic", commit=JCommitPolicy(mode="net-positive")),
        faults=jfaults.FaultInjector([jfaults.FaultSpec(**spec)], seed=0)
    ).run(jevents.Trace(events=[], horizon=50.0))
    assert stats_dict(stats) == stats_dict(jstats)
    assert snap(got) == snap(want)


@pytest.mark.parametrize("n_gpus,rate", [(2, 30.0), (4, 5.0)])
def test_faulted_demand_run_equals_the_references(n_gpus, rate):
    specs = [dict(kind="gpu_failure", at=(30.0,), gids=("a100-0",)),
             dict(kind="slice_failure", at=(60.0,), duration=20.0)]
    fleet, stats = _demand(FaultInjector([FaultSpec(**s) for s in specs], seed=1),
                           rate=rate, n_gpus=n_gpus)
    jfleet, jstats = _demand(jfaults.FaultInjector([jfaults.FaultSpec(**s) for s in specs],
                                                   seed=1),
                             rate=rate, n_gpus=n_gpus, port=False)
    assert stats_dict(stats) == stats_dict(jstats)
    assert snap(fleet) == snap(jfleet)
    assert stats.n_fault_evictions >= 1
