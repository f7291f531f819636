"""The port's online and demand simulators, test-case generator, fleet
builder and trace report: ``repro_torch.core.{events,simulator,fleetgen}``
and ``repro_torch.obs.report`` against the reference's.

The reference's ``tests/test_events.py``, the ``TestDemandSimulator`` cases
of ``tests/test_autoscale.py`` and the report cases of ``tests/test_obs.py``
run on the port.  On the same seeds both packages' generators give the same
fleets, cases and traces, both ``OnlineSimulator``s and
``DemandSimulator``s give equal ``TraceStats`` (all but the engine's wall
seconds) and final layouts, and both telemetries record the same
simulated-time events.  The port's torch sweep replays a trace as its numpy
sweep does.  Every port engine names its fabric backend (None: numpy,
``"cpu"``: torch on the host): without one it sweeps on the card.  Every
test leaves both packages' telemetry disabled and writes only under
``tmp_path``.
"""
import dataclasses
import json

import pytest

from repro import obs as jobs
from repro.core import events as jevents
from repro.core import fleetgen as jfleetgen
from repro.core import simulator as jsimulator
from repro.core.autoscaler import (
    SLO as JSLO,
    Autoscaler as JAutoscaler,
    AutoscalerConfig as JAutoscalerConfig,
)
from repro.core.engine import PlacementEngine as JPlacementEngine
from repro.core.profiles import A100_80GB as J_A100
from repro.core.tpu_profiles import TPU_V5E_POD as J_TPU
from repro.core.traffic import (
    ConstantRate as JConstantRate,
    FlashCrowd as JFlashCrowd,
    ModelTraffic as JModelTraffic,
    generate_requests as jgenerate_requests,
)
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.core.autoscaler import SLO, Autoscaler, AutoscalerConfig
from repro_torch.core.engine import PlacementEngine
from repro_torch.core.events import (
    DemandSimulator,
    Event,
    ModelServiceSpec,
    OnlineSimulator,
    Trace,
    build_fleet,
    generate_trace,
)
from repro_torch.core.profiles import A100_80GB, H100_80GB
from repro_torch.core.simulator import generate_test_case
from repro_torch.core.state import ClusterState, Workload
from repro_torch.core.tpu_profiles import TPU_V5E_POD
from repro_torch.core.traffic import (
    ConstantRate,
    DiurnalRate,
    FlashCrowd,
    ModelTraffic,
    generate_requests,
)
from repro_torch.obs import report


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    yield
    obs.disable()
    jobs.disable()


def _placed_wids(state):
    return {p.wid for g in state.gpus.values() for p in g.placements}


def _layout(state):
    return sorted(
        (gid, p.wid, p.profile_id, p.index)
        for gid, g in state.gpus.items()
        for p in g.placements
    )


def _stats(stats):
    d = stats.as_dict()
    d.pop("engine_seconds")  # wall clock
    return d


# ---------------------------------------------------------------------------
# tests/test_events.py on the port
# ---------------------------------------------------------------------------
class TestDeterministicTrace:
    def _trace(self):
        burst = (
            Workload("w0", 5),   # 4g.40gb
            Workload("w1", 9),   # 3g.40gb
            Workload("w2", 14),  # 2g.20gb
            Workload("w3", 15),  # 1g.20gb
        )
        events = [
            Event(time=1.0, kind="arrival", workloads=burst),
            Event(time=2.0, kind="arrival", workloads=(Workload("w4", 19),)),
            Event(time=5.0, kind="departure", wids=("w0", "w2")),
            Event(time=6.0, kind="compact"),
        ]
        return Trace(events=events, horizon=10.0)

    def test_known_final_layout_and_no_stranded_placements(self):
        state = ClusterState.homogeneous(3)
        sim = OnlineSimulator(state, PlacementEngine("rule_based", fabric_device=None))
        stats = sim.run(self._trace())
        state.validate()
        assert len(state.used_gpus()) == 1
        assert _placed_wids(state) == {"w1", "w3", "w4"}
        assert _placed_wids(state) == set(state.workloads)
        assert stats.n_placed == 5 and stats.n_rejected == 0
        assert stats.n_departed == 2
        assert stats.n_compactions == 1
        assert stats.n_migrations == 2
        assert stats.time_avg_gpus_used == pytest.approx((2 * 5 + 1 * 4) / 10)
        assert stats.peak_gpus_used == 2

    def test_migration_budget_rolls_back_compaction(self):
        state = ClusterState.homogeneous(3)
        sim = OnlineSimulator(
            state, PlacementEngine("rule_based", fabric_device=None), migration_budget=1
        )
        stats = sim.run(self._trace())
        state.validate()
        assert stats.n_compactions == 0
        assert stats.n_compactions_skipped == 1
        assert stats.n_migrations == 0
        assert len(state.used_gpus()) == 2
        assert _placed_wids(state) == {"w1", "w3", "w4"}

    def test_time_averages_clamp_to_horizon(self):
        state = ClusterState.homogeneous(2)
        trace = Trace(
            events=[
                Event(time=2.0, kind="arrival", workloads=(Workload("a", 5),)),
                Event(time=15.0, kind="departure", wids=("a",)),
            ],
            horizon=10.0,
        )
        stats = OnlineSimulator(state, PlacementEngine("rule_based", fabric_device=None)).run(trace)
        assert stats.time_avg_gpus_used == pytest.approx(0.8)
        assert stats.time_avg_mem_occupancy == pytest.approx(0.8 * 4 / 16)
        assert stats.n_departed == 1
        assert state.used_gpus() == []

    def test_periodic_compaction_injection(self):
        state = ClusterState.homogeneous(3)
        trace = Trace(
            events=[
                Event(time=1.0, kind="arrival", workloads=(Workload("a", 15),)),
                Event(time=2.0, kind="arrival", workloads=(Workload("b", 15),)),
            ],
            horizon=20.0,
        )
        sim = OnlineSimulator(
            state, PlacementEngine("rule_based", fabric_device=None), compact_every=5.0
        )
        stats = sim.run(trace)
        assert stats.n_compactions + stats.n_compactions_skipped == 3


class TestGeneratedTraces:
    def _fleet(self):
        return build_fleet([(A100_80GB, 4), (TPU_V5E_POD, 2)])

    def test_build_fleet_repeated_entries_do_not_collide(self):
        fleet = build_fleet([(A100_80GB, 2), (A100_80GB, 3), (TPU_V5E_POD, 1)])
        assert len(fleet.gpus) == 6
        assert sorted(g for g in fleet.gpus if g.startswith("a100")) == [
            f"a100-{i}" for i in range(5)
        ]

    def test_trace_generation_is_deterministic(self):
        fleet = self._fleet()
        a = generate_trace(42, fleet, horizon=50.0)
        b = generate_trace(42, fleet, horizon=50.0)
        assert [(e.time, e.kind, e.workloads, e.wids) for e in a.events] == [
            (e.time, e.kind, e.workloads, e.wids) for e in b.events
        ]
        assert a.n_arrivals > 0

    def test_workloads_target_fleet_kinds(self):
        fleet = self._fleet()
        tr = generate_trace(7, fleet, horizon=50.0)
        kinds = {w.device_kind for e in tr.events for w in e.workloads}
        assert kinds <= {"A100-80GB", "TPUv5e-16x16-pod"}
        assert len(kinds) == 2

    @pytest.mark.parametrize("policy", ["first_fit", "load_balanced", "rule_based"])
    def test_mixed_fleet_trace_completes(self, policy):
        fleet = self._fleet()
        trace = generate_trace(0, fleet, horizon=60.0, arrival_rate=0.8)
        sim = OnlineSimulator(fleet, PlacementEngine(policy, fabric_device=None),
                              compact_every=15.0)
        stats = sim.run(trace)
        fleet.validate()
        assert stats.n_arrived == stats.n_placed + stats.n_rejected
        assert _placed_wids(fleet) == set(fleet.workloads)
        assert 0.0 <= stats.time_avg_mem_occupancy <= 1.0
        assert stats.time_avg_gpus_used > 0.0
        assert stats.peak_gpus_used <= len(fleet.gpus)

    def test_departures_only_for_generated_arrivals(self):
        fleet = self._fleet()
        tr = generate_trace(3, fleet, horizon=40.0)
        arrived = {w.wid for e in tr.events for w in e.workloads}
        departing = {wid for e in tr.events for wid in e.wids}
        assert departing <= arrived

    def test_h100_80gb_arrivals_draw_the_a100_pool(self):
        """The port's one addition: an H100 80GB fleet draws the A100 80GB's
        profile pool (same MIG geometry), so its traces match the A100's."""
        a = generate_trace(5, build_fleet([(A100_80GB, 8)]), horizon=40.0)
        h = generate_trace(5, build_fleet([(H100_80GB, 8)]), horizon=40.0)
        assert [(e.time, e.kind, [w.profile_id for w in e.workloads], e.wids)
                for e in a.events] == \
            [(e.time, e.kind, [w.profile_id for w in e.workloads], e.wids)
             for e in h.events]


# ---------------------------------------------------------------------------
# tests/test_autoscale.py::TestDemandSimulator on the port
# ---------------------------------------------------------------------------
def _slo():
    return SLO(ttft_seconds=2.0, tpot_seconds=0.05)


def _spec(model="chat", pid=9, **kw):
    return ModelServiceSpec(model=model, profile_id=pid, slo=_slo(), **kw)


class TestDemandSimulator:
    def _run(self, specs, traffic_specs, n_gpus=8, horizon=150.0, seed=0,
             scaler=None, **kw):
        fleet = build_fleet([(A100_80GB, n_gpus)])
        traffic = generate_requests(traffic_specs, seed=seed, horizon=horizon)
        sim = DemandSimulator(
            fleet, PlacementEngine("rule_based", fabric_device=None), specs,
            autoscaler=scaler, **kw,
        )
        stats = sim.run(traffic)
        fleet.validate()
        return fleet, stats

    def test_all_requests_accounted(self):
        fleet, stats = self._run(
            [_spec(initial_replicas=2)],
            [ModelTraffic("chat", ConstantRate(2.0))],
            scaler=Autoscaler(AutoscalerConfig(up_cooldown=0.0)),
        )
        assert stats.n_requests > 0
        assert stats.n_completed + stats.n_unserved == stats.n_requests
        assert 0.0 <= stats.slo_attainment <= 1.0
        assert stats.slo_attainment_by_model.keys() == {"chat"}

    def test_static_mode_never_scales(self):
        fleet, stats = self._run(
            [_spec(initial_replicas=3)],
            [ModelTraffic("chat", ConstantRate(2.0))],
            scaler=None,
        )
        assert stats.n_scale_ups == stats.n_scale_downs == 0
        assert len(fleet.workloads) == 3

    def test_flash_crowd_triggers_scale_up_then_down(self):
        fleet, stats = self._run(
            [_spec(initial_replicas=1)],
            [ModelTraffic("chat", FlashCrowd(0.5, 40.0, 30.0, 8.0),
                          mean_prompt_len=2048, mean_decode_len=256)],
            horizon=200.0,
            scaler=Autoscaler(AutoscalerConfig(up_cooldown=0.0, down_cooldown=20.0)),
        )
        assert stats.n_scale_ups > 0
        assert stats.n_scale_downs > 0
        assert stats.n_autoscale_ticks > 0

    def test_deterministic_replay(self):
        kw = dict(
            specs=[_spec(initial_replicas=1)],
            traffic_specs=[ModelTraffic("chat", DiurnalRate(2.0, period=80.0))],
            scaler=Autoscaler(AutoscalerConfig(up_cooldown=0.0)),
        )
        _, a = self._run(**kw)
        kw["scaler"] = Autoscaler(AutoscalerConfig(up_cooldown=0.0))
        _, b = self._run(**kw)
        assert _stats(a) == _stats(b)

    def test_resize_right_sizes_on_ladder(self):
        fleet, stats = self._run(
            [_spec(pid=9, profile_ladder=(9, 15, 19), initial_replicas=2)],
            [ModelTraffic("chat", ConstantRate(0.2), mean_prompt_len=64, mean_decode_len=8)],
            scaler=Autoscaler(AutoscalerConfig(up_cooldown=0.0)),
        )
        assert stats.n_resizes > 0
        for w in fleet.workloads.values():
            assert w.profile_id in (9, 15, 19)

    def test_unknown_traffic_model_rejected(self):
        fleet = build_fleet([(A100_80GB, 2)])
        sim = DemandSimulator(fleet, PlacementEngine("rule_based", fabric_device=None), [_spec()])
        bad = generate_requests([ModelTraffic("ghost", ConstantRate(1.0))], seed=0,
                                horizon=10.0)
        with pytest.raises(ValueError, match="ghost"):
            sim.run(bad)

    def test_migrations_flow_through_commit_policy(self):
        fleet, stats = self._run(
            [_spec(initial_replicas=4)],
            [ModelTraffic("chat", DiurnalRate(3.0, period=100.0))],
            scaler=Autoscaler(AutoscalerConfig(up_cooldown=0.0, down_cooldown=10.0)),
            compact_every=20.0,
        )
        assert stats.n_compactions + stats.n_compactions_skipped > 0
        if stats.n_migrations:
            assert stats.bytes_moved > 0


# ---------------------------------------------------------------------------
# the port against the reference on the same seeds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_gpus", [8, 64])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_generate_test_case_equals_the_references(seed, n_gpus):
    tc = generate_test_case(seed, n_gpus=n_gpus)
    jtc = jsimulator.generate_test_case(seed, n_gpus=n_gpus)
    assert tc.name == jtc.name
    assert _layout(tc.initial) == _layout(jtc.initial)
    assert [dataclasses.astuple(w) for w in tc.initial.workloads.values()] == \
        [dataclasses.astuple(w) for w in jtc.initial.workloads.values()]
    assert [dataclasses.astuple(w) for w in tc.new_workloads] == \
        [dataclasses.astuple(w) for w in jtc.new_workloads]


def test_build_fleet_equals_the_references():
    spec = [(A100_80GB, 3), (TPU_V5E_POD, 2), (A100_80GB, 2)]
    jspec = [(J_A100, 3), (J_TPU, 2), (J_A100, 2)]
    for fmt in ("{tag}-{i}", "{tag}{i}"):
        fleet = build_fleet(spec, gid_format=fmt)
        jfleet = jfleetgen.build_fleet(jspec, gid_format=fmt)
        assert [(g, s.device.name) for g, s in fleet.gpus.items()] == \
            [(g, s.device.name) for g, s in jfleet.gpus.items()]
    with pytest.raises(ValueError, match="collision"):
        build_fleet([(A100_80GB, 2)], gid_format="gpu")


def _trace_key(trace):
    return [(e.time, e.kind, [dataclasses.astuple(w) for w in e.workloads], e.wids)
            for e in trace.events], trace.horizon


ONLINE_CASES = [
    # (policy, fabric_device, sim kwargs)
    ("first_fit", None, dict(compact_every=15.0)),
    ("load_balanced", None, dict(compact_every=15.0)),
    ("rule_based", None, dict(compact_every=15.0, migration_budget=2)),
    ("rule_based", None, dict(reconfigure_every=25.0)),
    ("frag_aware", None, dict(compact_every=15.0)),
    ("frag_aware", "cpu", dict(compact_every=15.0, reconfigure_every=30.0)),
]


@pytest.mark.parametrize("policy,device,kw", ONLINE_CASES,
                         ids=[f"{p}-{d}-{'-'.join(k)}" for p, d, k in ONLINE_CASES])
def test_online_simulator_equals_the_references(policy, device, kw):
    """One seeded trace over a mixed A100 + TPU fleet through both
    packages: equal traces, stats, final layouts and simulated-time
    telemetry events."""
    fleet = build_fleet([(A100_80GB, 6), (TPU_V5E_POD, 2)])
    jfleet = jfleetgen.build_fleet([(J_A100, 6), (J_TPU, 2)])
    trace = generate_trace(11, fleet, horizon=80.0, arrival_rate=0.6, mean_lifetime=30.0)
    jtrace = jevents.generate_trace(11, jfleet, horizon=80.0, arrival_rate=0.6,
                                    mean_lifetime=30.0)
    assert _trace_key(trace) == _trace_key(jtrace)
    with obs.enabled() as tel, jobs.enabled() as jtel:
        stats = OnlineSimulator(fleet, PlacementEngine(policy, fabric_device=device),
                                **kw).run(trace)
        jstats = jevents.OnlineSimulator(jfleet, JPlacementEngine(policy), **kw).run(jtrace)
    fleet.validate()
    assert _stats(stats) == _stats(jstats)
    assert _layout(fleet) == _layout(jfleet)
    assert [e.as_dict() for e in tel.tracer.events] == \
        [e.as_dict() for e in jtel.tracer.events]


def test_online_trace_torch_sweep_equals_numpy():
    """A 128-GPU H100 80GB trace (the fabric's ``auto`` threshold) with the
    scaling of the fleet-scale trace: the torch sweep replays it as the
    numpy sweep does."""
    runs = []
    for device in (None, "cpu"):
        fleet = build_fleet([(H100_80GB, 128)])
        trace = generate_trace(2, fleet, horizon=12.0, arrival_rate=128 / 8.0,
                               mean_lifetime=0.6 * 12.0)
        stats = OnlineSimulator(fleet, PlacementEngine("frag_aware", fabric_device=device),
                                compact_every=4.0).run(trace)
        fleet.validate()
        runs.append((_stats(stats), _layout(fleet)))
    assert runs[0] == runs[1]
    assert runs[0][0]["n_placed"] > 100


def _demand_run(pkg, policy, device=None):
    """chat (ladder, autoscaled) + best-effort bot over 8 A100s, with
    periodic compaction, through ``pkg``'s classes."""
    port = pkg == "port"
    slo = (SLO if port else JSLO)(ttft_seconds=2.0, tpot_seconds=0.05)
    spec_cls = ModelServiceSpec if port else jevents.ModelServiceSpec
    specs = [spec_cls(model="chat", profile_id=9, slo=slo, profile_ladder=(9, 15, 19),
                      initial_replicas=2),
             spec_cls(model="bot", profile_id=19, slo=slo, initial_replicas=1,
                      best_effort=True)]
    mt, cr, fc = ((ModelTraffic, ConstantRate, FlashCrowd) if port
                  else (JModelTraffic, JConstantRate, JFlashCrowd))
    traffic = (generate_requests if port else jgenerate_requests)(
        [mt("chat", fc(0.5, 40.0, 30.0, 8.0), mean_prompt_len=2048, mean_decode_len=256),
         mt("bot", cr(1.0))], seed=4, horizon=150.0)
    fleet = (build_fleet([(A100_80GB, 8)]) if port
             else jfleetgen.build_fleet([(J_A100, 8)]))
    scaler = (Autoscaler(AutoscalerConfig(up_cooldown=0.0, down_cooldown=20.0)) if port
              else JAutoscaler(JAutoscalerConfig(up_cooldown=0.0, down_cooldown=20.0)))
    engine = (PlacementEngine(policy, fabric_device=device) if port
              else JPlacementEngine(policy))
    sim_cls = DemandSimulator if port else jevents.DemandSimulator
    stats = sim_cls(fleet, engine, specs, autoscaler=scaler, compact_every=30.0).run(traffic)
    fleet.validate()
    return _stats(stats), _layout(fleet)


@pytest.mark.parametrize("policy,device", [("rule_based", None), ("frag_aware", None),
                                           ("frag_aware", "cpu")])
def test_demand_simulator_equals_the_references(policy, device):
    stats, layout = _demand_run("port", policy, device)
    jstats, jlayout = _demand_run("ref", policy)
    assert stats == jstats
    assert layout == jlayout
    assert stats["n_scale_ups"] > 0 and stats["n_requests"] > 0


# ---------------------------------------------------------------------------
# tests/test_obs.py::TestReport on the port's obs.report
# ---------------------------------------------------------------------------
def _run_trace(seed: int = 11, pkg="port"):
    port = pkg == "port"
    fleet = (build_fleet([(A100_80GB, 6), (TPU_V5E_POD, 1)]) if port
             else jfleetgen.build_fleet([(J_A100, 6), (J_TPU, 1)]))
    trace = (generate_trace if port else jevents.generate_trace)(
        seed, fleet, horizon=80.0, arrival_rate=0.5, mean_lifetime=30.0)
    sim = (OnlineSimulator if port else jevents.OnlineSimulator)(
        fleet, (PlacementEngine("rule_based", fabric_device=None) if port
                else JPlacementEngine("rule_based")),
        compact_every=20.0)
    return sim.run(trace), _layout(fleet)


class TestReport:
    def test_report_renders_from_generated_spans(self, tmp_path, capsys):
        tel = obs.enable()
        _run_trace(seed=3)
        dest = tmp_path / "spans.jsonl"
        obs.write_jsonl(tel.tracer.records(), dest)
        report.main([str(dest), "--width", "60"])
        out = capsys.readouterr().out
        assert "per-span latency" in out
        assert "deploy" in out
        spans, _events = report.load_records(str(dest))
        rows = report.latency_table(spans)
        deploy = next(r for r in rows if r["name"] == "deploy")
        assert deploy["count"] > 0
        assert deploy["p50_s"] <= deploy["p95_s"] <= deploy["p99_s"]

    def test_html_timeline(self, tmp_path):
        tel = obs.enable()
        _run_trace(seed=3)
        dest = tmp_path / "spans.jsonl"
        obs.write_jsonl(tel.tracer.records(), dest)
        html = tmp_path / "report.html"
        report.main([str(dest), "--html", str(html)])
        text = html.read_text()
        assert text.lstrip().lower().startswith("<!doctype html>")
        assert "deploy" in text


def test_report_equals_the_references(tmp_path):
    """Both packages' reports over their own runs of one seeded trace: the
    same span counts per name and the same simulated-time timeline."""
    outs = []
    for pkg, o, rep in (("port", obs, report), ("ref", jobs, jreport)):
        tel = o.enable()
        _run_trace(seed=5, pkg=pkg)
        dest = tmp_path / f"{pkg}.jsonl"
        o.write_jsonl(tel.tracer.records(), dest)
        o.disable()
        spans, events = rep.load_records(str(dest))
        outs.append(({r["name"]: r["count"] for r in rep.latency_table(spans)},
                     rep.ascii_timeline(events, width=60),
                     [json.dumps(e, sort_keys=True) for e in events]))
    assert outs[0] == outs[1]
    assert outs[0][0].get("deploy", 0) > 0
