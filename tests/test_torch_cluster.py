"""The port's placement-integrated ClusterServer.

Three groups of tests:
  * the reference's own cluster tests (``tests/test_system.py`` and the
    step-machine / fault-API classes of ``tests/test_faults.py``) carried
    over to ``repro_torch.serving.cluster``, whose default device is the
    H100 80GB's MIG geometry;
  * parity against ``repro.serving.cluster``: one scripted sequence of
    verbs (the reference CLI's model mix: deploy chat / code / draft,
    retire, compact, reconfigure, then fail_node, repair_node and an
    autoscale tick) runs on both servers, compared exactly after every verb
    for three device models, the four policies and two commit modes, with
    footprint sizing, telemetry counters, and a served run whose tokens
    must be identical per request id;
  * the cluster launchers on the CPU.
"""
import dataclasses
import functools
import logging
import sys

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config, reduced
from repro.core import autoscaler as jauto
from repro.core.profiles import A100_80GB as J_A100, H100_96GB as J_H100_96
from repro.core.tpu_profiles import TPU_V5E_POD as J_TPU
from repro.launch import serve as jserve
from repro.models import bundle as jbundle
from repro.models import layers as jlayers
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig, Request as JRequest
from repro.serving import cluster as jcluster
from repro_torch import obs
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.core import autoscaler as tauto
from repro_torch.core.migration import MigrationPlan, Move
from repro_torch.core.profiles import A100_80GB, H100_80GB, H100_96GB
from repro_torch.core.state import Workload
from repro_torch.core.tpu_profiles import TPU_V5E_POD
from repro_torch.kernels import ops
from repro_torch.launch import serve, serve_cluster
from repro_torch.models import bundle as tbundle
from repro_torch.models import layers
from repro_torch.serving import (
    ClusterServer,
    Engine,
    EngineConfig,
    NoReplicaError,
    PlanExecutionError,
    Request,
    StepPolicy,
)
from repro_torch.serving import cluster as tcluster
from repro_torch.serving.cluster import replica_footprint_parts, replica_profile

#: the reference CLI's cluster mix (``repro/launch/serve.py``)
MIX = (("chat", "smollm-135m", 5), ("code", "chatglm3-6b", 3), ("draft", "xlstm-125m", 2))
#: the same models at lower counts, for the MIP on the 16-row TPU pod: there
#: the reference's index assignment (``core/indexing.py:assign_indexes``)
#: searches every start row for each identical 1-row block, and re-placing
#: the six replicas a failed pod held took 147 s per package on the CPU
SMALL_MIX = (("chat", "smollm-135m", 3), ("code", "chatglm3-6b", 2), ("draft", "xlstm-125m", 1))
POLICIES = ["heuristic", "mip", "first_fit", "load_balanced"]
#: port device model -> the reference's object of the same geometry
DEVICES = {"TPUv5e-16x16-pod": (TPU_V5E_POD, J_TPU), "A100-80GB": (A100_80GB, J_A100),
           "H100-96GB": (H100_96GB, J_H100_96)}
SIZEABLE = ["smollm-135m", "chatglm3-6b", "zamba2-1.2b", "xlstm-125m",
            "mistral-large-123b", "nemotron-4-340b"]


@pytest.fixture(autouse=True, scope="module")
def _cached_reference_sizing():
    """Size each reference arch once per module (``jax.eval_shape`` costs
    ~0.1 s an arch); the port's sizing is held to it in its own test."""
    real = jcluster.replica_footprint_parts
    jcluster.replica_footprint_parts = functools.lru_cache(maxsize=None)(real)
    yield
    jcluster.replica_footprint_parts = real


# ---------------------------------------------------------------------------
# the reference's cluster tests, on the port (tests/test_system.py)
# ---------------------------------------------------------------------------
def test_replica_profile_scales_with_arch():
    small = replica_profile("smollm-135m", max_batch=4, max_len=2048)
    big = replica_profile("nemotron-4-340b", max_batch=4, max_len=2048)
    assert small.memory_slices < big.memory_slices
    assert (small.profile_id, big.profile_id) == (19, 0)  # 1g.10gb; the whole card
    # 340B bf16 weights do not fit an 80 GB card: the reference's sizing
    # gives the full-device profile anyway, and the port keeps that
    pod = replica_profile("nemotron-4-340b", max_batch=4, max_len=2048, device=TPU_V5E_POD)
    assert pod.memory_slices * TPU_V5E_POD.mem_per_slice_gb >= 680  # > 340B bf16


def test_replica_profiles_on_the_h100_at_the_chip_shape():
    """The serving shape of the card's cluster phase: both models of the
    reference mix fit the smallest MIG slice."""
    for arch in ("smollm-135m", "xlstm-125m"):
        assert replica_profile(arch, max_batch=8, max_len=2048).name == "1g.10gb"
    # equal memory slices: the stable sort keeps Table 1's order (2g before 1g)
    assert replica_profile("chatglm3-6b", max_batch=8, max_len=8192).name == "2g.20gb"


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_deploy_policies(policy):
    srv = ClusterServer(n_nodes=4, policy=policy)
    rep = srv.deploy("chat", "smollm-135m", n_replicas=6, max_batch=4, max_len=2048)
    assert len(rep.placed) == 6 and not rep.pending
    srv.state.validate()
    assert srv.metrics().n_gpus >= 1
    assert srv.device is H100_80GB


@pytest.mark.parametrize("device,big,small", [(H100_80GB, 14, 19), (TPU_V5E_POD, 3, 4)],
                         ids=["h100-80gb", "tpu-pod"])
def test_cluster_compaction_saves_nodes(device, big, small):
    srv = ClusterServer(n_nodes=6, device=device, policy="heuristic")
    # fragment the cluster: deploy then retire interleaved replicas
    srv.deploy("a", "smollm-135m", 8, profile_id=big)
    srv.deploy("b", "smollm-135m", 4, profile_id=small)
    srv.retire("a", 6)
    frag = srv.metrics()
    report = srv.compact()
    srv.state.validate()
    assert report.after.n_gpus <= frag.n_gpus
    assert report.plan.n_moves >= 0  # plan is executable
    # every surviving replica still placed exactly once
    for wid in srv.replicas:
        assert srv.state.gpu_of(wid) is not None


def test_cluster_reconfigure_eviction_retires_ghosts():
    """A committed reconfigure that cannot re-place a replica must retire it
    from every server-side map (no ghost in routing/engines/footprints)."""
    srv = ClusterServer(n_nodes=4, policy="heuristic")
    srv.deploy("m", "smollm-135m", 3, profile_id=19)
    victim = sorted(srv.replicas)[0]
    srv.attach_engine(victim, object())

    real = srv.engine.reconfigure

    def evicting(state):
        res = real(state)
        gid = state.gpu_of(victim)
        state.gpus[gid].remove(victim)  # the replay "failed" to re-place it
        res.pending = [Workload(victim, 19, model="m")]
        return res

    srv.engine.reconfigure = evicting
    rep = srv.reconfigure()
    assert rep.evicted == [victim]
    assert victim not in srv.replicas
    assert victim not in srv.engines
    assert victim not in srv.state.workloads
    assert victim not in srv.replicas_of("m")
    srv.state.validate()


def test_cluster_reconfigure_and_route():
    srv = ClusterServer(n_nodes=8, policy="heuristic")
    srv.deploy("m", "smollm-135m", 5, profile_id=19)
    rep = srv.reconfigure()
    assert rep.after.n_gpus <= rep.before.n_gpus
    picks = [srv.route("m") for _ in range(10)]
    assert len(set(picks)) == len(srv.replicas_of("m"))  # round robin covers all


def _port_engine_pair(arch, seed=0):
    mb = tbundle(t_reduced(t_get_config(arch)))
    return mb, mb.init(torch.Generator().manual_seed(seed), device="cpu")


def test_cluster_end_to_end_serving():
    """Deploy 2 models, attach real engines, route + pump to completion."""
    srv = ClusterServer(n_nodes=2, policy="heuristic")
    mb1, p1 = _port_engine_pair("smollm-135m")
    mb2, p2 = _port_engine_pair("xlstm-125m")
    srv.deploy("chat", "smollm-135m", 2, profile_id=19)
    srv.deploy("draft", "xlstm-125m", 1, profile_id=19)
    for wid in srv.replicas_of("chat"):
        srv.attach_engine(wid, Engine(mb1, p1, EngineConfig(max_slots=2, max_len=32)))
    for wid in srv.replicas_of("draft"):
        srv.attach_engine(wid, Engine(mb2, p2, EngineConfig(max_slots=2, max_len=32)))
    for i in range(4):
        srv.submit("chat", Request(rid=f"c{i}", prompt=[1, 2, 3 + i], max_new_tokens=3))
    srv.submit("draft", Request(rid="d0", prompt=[9, 8], max_new_tokens=3))
    total = srv.pump()
    done = [c for e in srv.engines.values() for c in e.completed]
    assert len(done) == 5
    assert total == sum(len(c.tokens) for c in done)
    # placement metrics still coherent after serving
    srv.state.validate()


def test_migration_prices_live_replicas_from_their_engine_cache():
    srv = ClusterServer(n_nodes=2, policy="heuristic")
    mb, p = _port_engine_pair("smollm-135m")
    srv.deploy("chat", "smollm-135m", 1, max_batch=2, max_len=32)
    wid = srv.replicas_of("chat")[0]
    weights_b, reserved_kv_b = srv._footprints[wid]
    eng = Engine(mb, p, EngineConfig(max_slots=2, max_len=32))
    srv.attach_engine(wid, eng)
    assert srv._replica_bytes(wid) == weights_b + tcluster.live_kv_bytes(eng.cache)
    assert srv._replica_bytes(wid) != weights_b + reserved_kv_b  # reduced engine cache
    assert srv._replica_bytes("nobody") is None


# ---------------------------------------------------------------------------
# ClusterServer step machine and fault API (tests/test_faults.py)
# ---------------------------------------------------------------------------
def snap(state):
    """Byte-identity fingerprint of a cluster state."""
    return (
        {gid: (tuple(g.placements), g.health) for gid, g in state.gpus.items()},
        dict(state.workloads),
    )


def _fragmented_server(**kw):
    """4 single-replica models, 2 retired -> compaction has real moves."""
    srv = ClusterServer(
        4, device=A100_80GB,
        step_policy=StepPolicy(backoff_seconds=0.0), **kw,
    )
    srv._sleep = lambda s: None  # no real backoff sleeps in tests
    for m in ("a", "b", "c", "d"):
        srv.deploy(m, "unused-arch", n_replicas=1, profile_id=9)
    srv.retire("a", 1)
    srv.retire("d", 1)
    return srv


class TestClusterStepMachine:
    def test_transient_failure_retries_and_commits(self):
        srv = _fragmented_server()
        srv.inject_step_failure("copy", times=1)
        rep = srv.compact()
        assert rep.committed
        assert rep.execution.completed
        assert rep.execution.n_retries == 1
        srv.state.validate()

    @pytest.mark.parametrize("kind", ["copy", "cutover"])
    def test_exhausted_retries_roll_back_byte_identical(self, kind):
        srv = _fragmented_server()
        before = snap(srv.state)
        srv.inject_step_failure(kind, times=99)
        rep = srv.compact()
        assert not rep.committed
        assert rep.execution is not None
        assert not rep.execution.completed
        assert rep.execution.rolled_back
        assert rep.execution.failed_step == kind
        assert snap(srv.state) == before
        srv.state.validate()

    @pytest.mark.parametrize("kind", ["drain", "copy", "resume"])
    def test_disruptive_plan_fails_at_each_step(self, kind):
        """Drive _execute_plan directly with a disruptive move so the
        drain/resume phases exist, and crash each step kind."""
        srv = _fragmented_server()
        gid = srv.state.gpu_of("b/r1")
        plan = MigrationPlan(
            waves=[[]],
            disruptive=[Move(
                wid="b/r1", src_gid=gid, src_index=4,
                dst_gid=gid, dst_index=4, profile_id=9, disruptive=True,
            )],
        )
        srv.inject_step_failure(kind, times=99)
        with pytest.raises(PlanExecutionError) as ei:
            srv._execute_plan(plan)
        assert ei.value.step == kind
        assert ei.value.report.failed_step == kind
        # steps before the failed one are journaled for resume
        if kind == "resume":
            assert ("drain", "b/r1", -1) in ei.value.journal
            assert ("copy", "b/r1", -1) in ei.value.journal

    def test_resume_mode_journals_and_resumes(self):
        srv = _fragmented_server(on_execution_failure="resume")
        srv.inject_step_failure("cutover", times=99)
        rep = srv.compact()
        assert rep.committed  # layout kept: the engine's commit stands
        assert rep.execution.resumable
        assert srv._pending_plan is not None
        done_before = set(srv._pending_plan[1])
        srv._failpoints.clear()
        out = srv.resume_execution()
        assert out.completed
        assert srv._pending_plan is None
        # the resumed run only executed steps missing from the journal
        assert all(
            (s.kind, s.wid, s.wave) not in done_before for s in out.steps
        )
        srv.state.validate()

    def test_resume_without_pending_is_noop(self):
        srv = _fragmented_server()
        assert srv.resume_execution() is None

    def test_step_policy_validation(self):
        with pytest.raises(ValueError):
            StepPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            ClusterServer(1, device=A100_80GB, on_execution_failure="panic")


class TestClusterFaultAPI:
    def test_route_raises_typed_error(self):
        srv = ClusterServer(2, device=A100_80GB)
        with pytest.raises(NoReplicaError) as ei:
            srv.route("ghost-model")
        assert ei.value.model == "ghost-model"
        assert isinstance(ei.value, LookupError)  # old callers still work

    def test_submit_backlogs_and_deploy_flushes(self):
        srv = ClusterServer(2, device=A100_80GB)
        assert srv.submit("m", object()) is None
        assert len(srv._backlog["m"]) == 1
        srv.deploy("m", "unused-arch", n_replicas=1, profile_id=9)
        assert len(srv._backlog["m"]) == 0

    def test_fail_node_recovers_elsewhere(self):
        srv = _fragmented_server()
        gid = srv.state.gpu_of("b/r1")
        report = srv.fail_node(gid)
        assert report["evicted"] == ["b/r1"]
        assert report["recovered"] == ["b/r1"]
        assert report["lost"] == []
        assert srv.state.gpus[gid].health == "failed"
        new_gid = srv.state.gpu_of("b/r1")
        assert new_gid is not None and new_gid != gid
        srv.state.validate()
        srv.repair_node(gid)
        assert srv.state.gpus[gid].health == "healthy"

    def test_fail_node_with_no_capacity_loses_replica(self):
        srv = ClusterServer(1, device=A100_80GB)
        srv.deploy("m", "unused-arch", n_replicas=1, profile_id=9)
        gid = srv.state.gpu_of("m/r0")
        report = srv.fail_node(gid)
        assert report["lost"] == ["m/r0"]
        assert "m/r0" not in srv.replicas
        assert srv.replicas_of("m") == []
        srv.state.validate()


# ---------------------------------------------------------------------------
# parity with the reference ClusterServer
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Pkg:
    ClusterServer: type
    StepPolicy: type
    Autoscaler: type
    AutoscalerConfig: type
    Request: type


PORT = _Pkg(ClusterServer, StepPolicy, tauto.Autoscaler, tauto.AutoscalerConfig, Request)
REF = _Pkg(jcluster.ClusterServer, jcluster.StepPolicy, jauto.Autoscaler,
           jauto.AutoscalerConfig, JRequest)


def _layout(srv):
    """{wid: (gid, index, profile_id)} over every placement."""
    return {pl.wid: (gid, pl.index, pl.profile_id)
            for gid, g in sorted(srv.state.gpus.items()) for pl in g.placements}


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _placement_report(rep):
    return {"before": _plain(rep.before), "after": _plain(rep.after), "plan": _plain(rep.plan),
            "cost": _plain(rep.cost), "committed": rep.committed,
            "execution": _plain(rep.execution), "evicted": rep.evicted}


def _script(pkg, device, policy, commit):
    """The reference CLI's sequence plus a failure, a repair and an
    autoscale tick; returns [(verb, what it reported, layout after it)]."""
    small = policy == "mip" and device.name == "TPUv5e-16x16-pod"
    mix, (retire_chat, retire_code) = (SMALL_MIX, (1, 1)) if small else (MIX, (3, 1))
    srv = pkg.ClusterServer(
        n_nodes=4, device=device, policy=policy, mip_time_limit=5.0, commit=commit,
        step_policy=pkg.StepPolicy(backoff_seconds=0.0),
        autoscaler=pkg.Autoscaler(pkg.AutoscalerConfig(
            mode="slo", up_cooldown=0.0, down_cooldown=0.0, min_replicas=1,
            max_replicas=4)),
        autoscale_window=10.0,
    )
    srv._sleep = lambda s: None
    out = []
    for model, arch, n in mix:
        rep = srv.deploy(model, arch, n, max_batch=8, max_len=4096)
        out.append((f"deploy {model}", {"placed": rep.placed, "pending": rep.pending,
                                        "plan": _plain(rep.plan), "cost": _plain(rep.cost),
                                        "metrics": _plain(rep.metrics)}, _layout(srv)))
    out.append(("utilization", srv.utilization(), None))
    out.append(("retire chat", srv.retire("chat", retire_chat), _layout(srv)))
    out.append(("retire code", srv.retire("code", retire_code), _layout(srv)))
    out.append(("compact", _placement_report(srv.compact()), _layout(srv)))
    out.append(("reconfigure", _placement_report(srv.reconfigure()), _layout(srv)))
    gid = min(g for g, _, _ in _layout(srv).values())
    out.append(("fail_node", srv.fail_node(gid), _layout(srv)))
    srv.repair_node(gid)
    out.append(("repair_node", srv.metrics().as_dict(), _layout(srv)))
    for i in range(12):
        model = "chat" if i % 3 else "draft"
        srv.submit(model, pkg.Request(rid=f"q{i}", prompt=list(range(1, 9 + i)),
                                      max_new_tokens=4 + i), now=100.0 + i * 0.5)
    rep = srv.autoscale(now=106.0, attainment={"chat": 0.5, "draft": 1.0})
    out.append(("autoscale", _plain(rep), _layout(srv)))
    out.append(("final metrics", srv.metrics().as_dict(), _layout(srv)))
    return out


def _assert_same_script(got, want):
    assert [v for v, _, _ in got] == [v for v, _, _ in want]
    for (verb, g_rep, g_lay), (_, w_rep, w_lay) in zip(got, want):
        assert g_lay == w_lay, f"layout after {verb}"
        assert g_rep == w_rep, f"report of {verb}"


@pytest.mark.parametrize("commit", ["always", "net-positive"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("device", sorted(DEVICES))
def test_scripted_verbs_match_reference(device, policy, commit):
    tdev, jdev = DEVICES[device]
    _assert_same_script(_script(PORT, tdev, policy, commit),
                        _script(REF, jdev, policy, commit))


@pytest.mark.parametrize("policy", POLICIES)
def test_h100_80gb_places_as_the_reference_a100_80gb(policy):
    """Same 7/8-slice geometry and 10 GB slices: the port's device model of
    the card places every verb exactly as the reference's A100 80GB.  The
    autoscale tick is left out: the perf model has a planning rate for
    "A100-80GB" and none for "H100-80GB" (it takes the per-GB fallback until
    the card is calibrated), so the replica capacities differ by design."""
    got = _script(PORT, H100_80GB, policy, "always")
    want = _script(REF, J_A100, policy, "always")
    cut = [v for v, _, _ in got].index("autoscale")
    _assert_same_script(got[:cut], want[:cut])
    assert got[0][2] and {p for _, _, p in got[0][2].values()} == {19}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16-kv", "int8-kv"])
@pytest.mark.parametrize("arch", SIZEABLE)
def test_replica_footprint_matches_reference(arch, kv_quant):
    layers.set_kv_quant(kv_quant)
    jlayers.set_kv_quant(kv_quant)
    try:
        for shape in ((8, 8192), (4, 2048)):
            got = replica_footprint_parts(arch, *shape)
            want = jcluster.replica_footprint_parts.__wrapped__(arch, *shape)
            assert got == want and all(isinstance(v, int) for v in got), (arch, shape)
    finally:
        layers.set_kv_quant(False)
        jlayers.set_kv_quant(False)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "seamless-m4t-large-v2", "mixtral-8x7b"])
def test_unported_family_sizing_raises(arch):
    with pytest.raises(NotImplementedError):
        replica_footprint_parts(arch, 8, 8192)


def _counters(registry):
    """Deterministic telemetry: counter values, and histogram observation
    counts (their sums are wall time)."""
    out = {}
    for inst in registry.instruments():
        key = (inst.kind, inst.name, inst.labels)
        out[key] = inst.value if inst.kind == "counter" else (
            inst.count if inst.kind == "histogram" else None)
    return out


@pytest.mark.parametrize("device", ["A100-80GB", "TPUv5e-16x16-pod"])
def test_telemetry_counters_match_reference(device):
    tdev, jdev = DEVICES[device]
    with obs.enabled() as tel, jobs.enabled() as jtel:
        _script(PORT, tdev, "heuristic", "always")
        _script(REF, jdev, "heuristic", "always")
    got, want = _counters(tel.metrics), _counters(jtel.metrics)
    assert got and got == want
    assert obs.get_telemetry().enabled is False  # restored


# ---------------------------------------------------------------------------
# served run, token for token against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bridged():
    """Reduced f32 smollm-135m and xlstm-125m: reference weights and the
    same weights bridged into the port."""
    out = {}
    for arch in ("smollm-135m", "xlstm-125m"):
        jmb = jbundle(reduced(get_config(arch)))
        jparams = jmb.init(jax.random.key(0))
        tmb = tbundle(t_reduced(t_get_config(arch)))
        tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg, device="cpu")
        out[arch] = ((jmb, jparams), (tmb, tparams))
    return out


def _served(pkg, engines, device):
    """Two chat and two draft replicas on 3g.40gb slices, requests in flight,
    one replica of each retired, compaction while the survivors decode, then
    pump to completion."""
    Eng, Cfg, Req, weights = engines
    srv = pkg.ClusterServer(n_nodes=4, device=device, policy="heuristic")
    srv.deploy("chat", "smollm-135m", 2, profile_id=9)
    srv.deploy("draft", "xlstm-125m", 2, profile_id=9)
    every = {}
    for wid, (_, arch) in sorted(srv.replicas.items()):
        mb, params = weights[arch]
        every[wid] = Eng(mb, params, Cfg(max_slots=2, max_len=64))
        srv.attach_engine(wid, every[wid])
    rng = np.random.default_rng(0)
    for i in range(10):
        model = "chat" if i < 6 else "draft"
        prompt = list(map(int, rng.integers(1, 255, size=int(rng.integers(2, 12)))))
        srv.submit(model, Req(rid=f"{model}{i}", prompt=prompt,
                              max_new_tokens=int(rng.integers(6, 14))))
    for _ in range(3):
        for eng in srv.engines.values():
            eng.step()
    retired = srv.retire("chat", 1) + srv.retire("draft", 1)
    busy = {w for w, e in srv.engines.items() if e.has_work}
    rep = srv.compact()
    total = srv.pump()
    done = {c.rid: (c.tokens, c.finish_reason) for e in every.values() for c in e.completed}
    stats = {w: dict(e.stats) for w, e in every.items()}
    return {"retired": retired, "busy": busy, "report": _placement_report(rep),
            "layout": _layout(srv), "tokens": total, "done": done, "stats": stats}


def test_served_cluster_matches_reference_tokens(bridged):
    jw = {a: pair[0] for a, pair in bridged.items()}
    tw = {a: pair[1] for a, pair in bridged.items()}
    got = _served(PORT, (Engine, EngineConfig, Request, tw), A100_80GB)
    want = _served(REF, (JEngine, JEngineConfig, JRequest, jw), J_A100)
    assert got == want
    assert len(got["done"]) == 10
    execution = got["report"]["execution"]
    moved = [s["wid"] for s in execution["steps"] if s["kind"] == "copy"]
    assert moved and set(execution["handoffs"]) == set(moved)
    assert set(moved) & got["busy"], "compaction moved no replica with requests in flight"


# ---------------------------------------------------------------------------
# the cluster launchers on the CPU
# ---------------------------------------------------------------------------
def _node_counts(text):
    return [line.split("nodes_used=")[1] for line in text.splitlines() if "nodes_used=" in line] \
        + [line.split(": ")[1] for line in text.splitlines()
           if "compaction:" in line or "reconfiguration:" in line]


@pytest.mark.parametrize("policy", ["heuristic", "first_fit"])
def test_serve_cluster_mode_node_counts_match_reference_cli(policy, capsys, monkeypatch):
    # the reference CLI places on its default TPU pod: give the port's the same nodes
    monkeypatch.setattr(serve, "CLUSTER_DEVICE", TPU_V5E_POD)
    assert serve.main(["--cluster", "--nodes", "4", "--policy", policy]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", "--cluster", "--nodes", "4", "--policy", policy])
    assert jserve.main() == 0
    want = capsys.readouterr().out
    assert got.splitlines()[0] == f"cluster: 4 nodes of TPUv5e-16x16-pod, policy={policy}"
    assert _node_counts(got) == _node_counts(want) and len(_node_counts(got)) == 5
    assert got.splitlines()[1:] == want.splitlines()[1:]


def test_serve_cluster_mode_defaults_to_h100_mig_nodes(capsys):
    ops.reset_launch_counts()
    assert serve.main(["--cluster"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cluster: 4 nodes of H100-80GB, policy=heuristic"
    assert "deploy draft (xlstm-125m) x2: placed=2 pending=0" in out
    assert ops.launch_counts() == {}  # placement only: no engine ran


def test_serve_cluster_launcher_runs_on_cpu(caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve_cluster"):
        res = serve_cluster.run(serve_cluster.argparse.Namespace(
            device="cpu", reduced=True, verbose=False))
    assert len(res["latencies"]) == res["n_requests"] > 0
    assert res["peak_replicas"]["chat"] > 1  # the flash crowd scaled chat up
    assert res["server"].device is H100_80GB
    assert "post-compaction serving OK" in caplog.text
