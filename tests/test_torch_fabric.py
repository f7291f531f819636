"""The port's placement fabric: ``repro_torch.core.fabric`` against the
scalar placement core and against ``repro.core.fabric``.

Every case of the reference's ``tests/test_fabric.py`` runs on the port,
with ``KERNELS = (None, "cpu")`` in place of ``use_jax``: ``None`` is the
numpy sweep, ``"cpu"`` the torch sweep on the CPU.  On the same states the
port's torch slabs must equal its numpy slabs and the reference's numpy and
JAX slabs bit for bit (bools and int32s), and engine verbs through either
backend must land the reference's layouts.  The ``gpu`` test runs the torch
sweep on the card (``device="cuda"``):
    python -m pytest -q -m gpu tests/test_torch_fabric.py

The reference package is imported inside the CPU tests only, so the ``gpu``
test also runs where JAX is not installed.  Every test leaves both
packages' telemetry disabled.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import baselines, fabric, heuristic, metrics
from repro_torch.core.engine import PlacementEngine
from repro_torch.core.fabric import (
    FleetFabric,
    fabric_first_fit,
    fabric_frag_aware_compact,
    fabric_frag_aware_deploy,
    fabric_frag_aware_reconfigure,
    fabric_initial_deployment,
    fabric_load_balanced,
    fleet_fabric,
)
from repro_torch.core.profiles import A100_80GB, H100_80GB, H100_96GB
from repro_torch.core.simulator import generate_test_case, random_workloads
from repro_torch.core.state import ClusterState, GPUState, Workload
from repro_torch.core.tpu_profiles import TPU_V5E_POD

SEEDS = (0, 1, 2, 3, 7)
KERNELS = (None, "cpu")  # FleetFabric(device=...): numpy, torch on the CPU
# (no device named means "cuda": every host run here names its backend)
POLICIES = ("first_fit", "load_balanced", "rule_based", "frag_aware")


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    yield
    obs.disable()
    ref_obs = sys.modules.get("repro.obs")
    if ref_obs is not None:
        ref_obs.disable()


@pytest.fixture(scope="module")
def ref():
    """The reference's placement core, imported here so that the ``gpu``
    test does not need JAX."""
    from repro.core import engine, fabric as jfabric, profiles, simulator, state, tpu_profiles

    return types.SimpleNamespace(
        engine=engine, fabric=jfabric, simulator=simulator, state=state,
        devices={d.name: d for d in (profiles.A100_80GB, profiles.H100_96GB,
                                     tpu_profiles.TPU_V5E_POD)},
    )


def _port_pkg():
    return types.SimpleNamespace(
        ClusterState=ClusterState, GPUState=GPUState, Workload=Workload,
        devices={d.name: d for d in (A100_80GB, H100_96GB, TPU_V5E_POD)},
    )


def _ref_pkg(ref):
    return types.SimpleNamespace(
        ClusterState=ref.state.ClusterState, GPUState=ref.state.GPUState,
        Workload=ref.state.Workload, devices=ref.devices,
    )


def _random_hetero_state(seed: int, pkg=None):
    """A randomly-populated mixed A100 + H100 + TPU fleet, built from the
    classes and device models of ``pkg`` (default: the port's)."""
    pkg = pkg or _port_pkg()
    rng = np.random.default_rng(seed)
    state = pkg.ClusterState()
    specs = [("A100-80GB", 5), ("H100-96GB", 3), ("TPUv5e-16x16-pod", 2)]
    wi = 0
    for name, count in specs:
        device = pkg.devices[name]
        for i in range(count):
            gid = f"{device.name.split('-')[0].lower()}-{i}"
            gpu = pkg.GPUState(gid, device)
            state.gpus[gid] = gpu
            pool = [p.profile_id for p in device.profiles]
            for _ in range(int(rng.integers(0, 5))):
                pid = int(rng.choice(pool))
                idx = gpu.first_feasible_index(device.profile(pid))
                if idx is None:
                    continue
                w = pkg.Workload(wid=f"w{wi}", profile_id=pid, device_kind=device.name)
                state.add_workload(w)
                gpu.place(w.wid, pid, idx)
                wi += 1
    return state


def _placements(state):
    return {
        (gid, p.wid, p.profile_id, p.index)
        for gid, g in state.gpus.items()
        for p in g.placements
    }


def _slabs(fab):
    waste, frag = fab._score_cache()
    return fab.feasible_all(), waste.copy(), frag.copy()


# ---------------------------------------------------------------------------
# kernel parity: feasibility over ALL triples == scalar can_place_at
# ---------------------------------------------------------------------------
class TestFeasibilityParity:
    @pytest.mark.parametrize("device", KERNELS)
    @pytest.mark.parametrize("seed", SEEDS)
    def test_all_triples_heterogeneous(self, seed, device):
        state = _random_hetero_state(seed)
        fab = FleetFabric(state, device=device)
        feas = fab.feasible_all()
        for r, gid in enumerate(fab.gids):
            gpu = state.gpus[gid]
            for p, prof in enumerate(gpu.device.profiles):
                for i in range(fab.M):
                    assert bool(feas[r, p, i]) == gpu.can_place_at(prof, i), (
                        gid, prof.name, i,
                    )
            for p in range(len(gpu.device.profiles), fab.P_max):
                assert not feas[r, p].any()

    def test_torch_and_numpy_sweeps_agree(self):
        state = _random_hetero_state(11)
        a = FleetFabric(state, device=None).feasible_all()
        b = FleetFabric(state, device="cpu").feasible_all()
        assert a.dtype == b.dtype == np.bool_
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("device", KERNELS)
    def test_incremental_row_refresh(self, device):
        """apply/unapply keep the cached all-triple slab exact."""
        tc = generate_test_case(5, n_gpus=6)
        state = tc.initial
        fab = FleetFabric(state, device=device)
        fab.feasible_all()
        prof = A100_80GB.profile(14)
        spot = fab.pick_first_fit(14)
        assert spot is not None
        gid, idx = spot
        state.add_workload(Workload(wid="zz", profile_id=14))
        state.place("zz", gid, idx)
        fab.apply(gid, prof, idx)
        np.testing.assert_array_equal(
            fab.feasible_all(), FleetFabric(state, device=device).feasible_all()
        )
        state.remove("zz", gid)
        fab.unapply(gid, prof, idx)
        np.testing.assert_array_equal(
            fab.feasible_all(), FleetFabric(state, device=device).feasible_all()
        )


# ---------------------------------------------------------------------------
# score parity: wastage / fragmentation vs scalar recomputation
# ---------------------------------------------------------------------------
class TestScoreParity:
    @pytest.mark.parametrize("device", KERNELS)
    @pytest.mark.parametrize("seed", SEEDS[:3])
    def test_waste_and_frag_vs_scalar(self, seed, device):
        state = _random_hetero_state(seed)
        fab = FleetFabric(state, device=device)
        for gid in fab.gids:
            gpu = state.gpus[gid]
            r = fab.row_of[gid]
            for prof in gpu.device.profiles:
                feas = fab.feasible_profile(prof.profile_id, gpu.device.name)
                waste, frag = fab.scores_profile(prof.profile_id, gpu.device.name)
                for i in range(gpu.device.n_memory_slices):
                    if not feas[r, i]:
                        continue
                    trial = gpu.clone()
                    before_mw = trial.memory_waste()
                    trial.place("_t", prof.profile_id, i)
                    want_waste = (
                        prof.compute_waste_at(i, gpu.device.n_gpu_slices)
                        + trial.memory_waste() - before_mw
                    )
                    occ = trial.memory_occupancy()
                    runs = 0
                    prev_free = False
                    for pos in range(gpu.device.n_memory_slices):
                        free = occ[pos] is None
                        if free and not prev_free:
                            runs += 1
                        prev_free = free
                    assert int(waste[r, i]) == want_waste, (gid, prof.name, i)
                    assert int(frag[r, i]) == runs, (gid, prof.name, i)


# ---------------------------------------------------------------------------
# fast-path placement identity vs the scalar policies
# ---------------------------------------------------------------------------
class TestDeployParity:
    @pytest.mark.parametrize("device", KERNELS)
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize(
        "scalar_fn,fabric_fn",
        [
            (baselines.first_fit, fabric_first_fit),
            (baselines.load_balanced, fabric_load_balanced),
            (heuristic.initial_deployment, fabric_initial_deployment),
        ],
        ids=["first_fit", "load_balanced", "rule_based"],
    )
    def test_identical_placements(self, scalar_fn, fabric_fn, seed, device):
        tc = generate_test_case(seed, n_gpus=10)
        s1, s2 = tc.initial.clone(), tc.initial.clone()
        p1 = scalar_fn(s1, tc.new_workloads)
        p2 = fabric_fn(s2, tc.new_workloads, device=device)
        assert _placements(s1) == _placements(s2)
        assert [w.wid for w in p1] == [w.wid for w in p2]

    @pytest.mark.parametrize("device", KERNELS)
    @pytest.mark.parametrize("policy", ["first_fit", "load_balanced", "rule_based"])
    @pytest.mark.parametrize("seed", SEEDS[:3])
    def test_engine_fabric_on_off_parity(self, policy, seed, device):
        tc = generate_test_case(seed, n_gpus=12)
        s_off, s_on = tc.initial.clone(), tc.initial.clone()
        PlacementEngine(policy, fabric="off", fabric_device=None).deploy(s_off, tc.new_workloads)
        PlacementEngine(policy, fabric="on", fabric_device=device).deploy(
            s_on, tc.new_workloads
        )
        assert _placements(s_off) == _placements(s_on)

    @pytest.mark.parametrize("seed", SEEDS[:3])
    def test_heterogeneous_routed_parity(self, seed):
        """Mixed fleet through the engine: fabric (both backends) and scalar
        paths agree."""
        rng = np.random.default_rng(seed)
        spec = [(A100_80GB, 6), (H100_96GB, 4)]
        news = []
        for device, n in spec:
            news += [
                Workload(
                    wid=f"{device.name}:{w.wid}",
                    profile_id=w.profile_id,
                    device_kind=device.name,
                )
                for w in random_workloads(rng, 3 * n, device)
            ]
        for policy in ("first_fit", "rule_based"):
            states = []
            for fab_mode, device in (("off", None), ("on", None), ("on", "cpu")):
                st = ClusterState(
                    gpus={
                        f"{d.name.split('-')[0].lower()}{i}": GPUState(
                            f"{d.name.split('-')[0].lower()}{i}", d
                        )
                        for d, n in spec
                        for i in range(n)
                    }
                )
                PlacementEngine(policy, fabric=fab_mode, fabric_device=device).deploy(st, news)
                st.validate()
                states.append(_placements(st))
            assert states[0] == states[1] == states[2], policy


# ---------------------------------------------------------------------------
# frag_aware policy semantics
# ---------------------------------------------------------------------------
class TestFragAware:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_deploy_valid_and_no_worse_than_rule_based(self, seed):
        tc = generate_test_case(seed, n_gpus=8)
        s_rule, s_frag = tc.initial.clone(), tc.initial.clone()
        heuristic.initial_deployment(s_rule, tc.new_workloads)
        pend = fabric_frag_aware_deploy(s_frag, tc.new_workloads, device="cpu")
        s_frag.validate()
        wl = list(tc.initial.workloads.values()) + list(tc.new_workloads)
        m_rule = metrics.evaluate(s_rule, tc.initial, wl)
        m_frag = metrics.evaluate(s_frag, tc.initial, wl)
        assert m_frag.n_gpus <= m_rule.n_gpus
        assert (
            m_frag.compute_wastage + m_frag.memory_wastage
            <= m_rule.compute_wastage + m_rule.memory_wastage
        )
        assert len(pend) <= m_rule.n_pending

    @pytest.mark.parametrize("device", KERNELS)
    def test_compact_one_shot_and_valid(self, device):
        tc = generate_test_case(4, n_gpus=8)
        state = tc.initial.clone()
        used_before = len(state.used_gpus())
        fabric_frag_aware_compact(state, device=device)
        state.validate()
        assert len(state.used_gpus()) <= used_before
        placed = [p.wid for g in state.gpus.values() for p in g.placements]
        assert sorted(placed) == sorted(
            p.wid for g in tc.initial.gpus.values() for p in g.placements
        )

    @pytest.mark.parametrize("device", KERNELS)
    def test_reconfigure_places_everything(self, device):
        tc = generate_test_case(6, n_gpus=8)
        state = tc.initial.clone()
        pending = fabric_frag_aware_reconfigure(state, device=device)
        state.validate()
        assert pending == []
        placed = {p.wid for g in state.gpus.values() for p in g.placements}
        assert placed == {
            p.wid for g in tc.initial.gpus.values() for p in g.placements
        }

    @pytest.mark.parametrize("seed", range(8))
    def test_reconfigure_never_evicts(self, seed):
        """Dense random-index layouts the greedy re-pack can't always match:
        reconfigure keeps the current layout rather than evict."""
        rng = np.random.default_rng(seed)
        state = ClusterState(
            gpus={f"g{i}": GPUState(f"g{i}", A100_80GB) for i in range(4)}
        )
        wi = 0
        for g in state.gpus.values():
            for _ in range(8):
                pid = int(rng.choice([5, 9, 14, 15, 19, 20]))
                prof = A100_80GB.profile(pid)
                feas = [i for i in prof.allowed_indexes if g.can_place_at(prof, i)]
                if not feas:
                    continue
                idx = int(rng.choice(feas))
                w = Workload(wid=f"p{wi}", profile_id=pid)
                wi += 1
                state.add_workload(w)
                g.place(w.wid, pid, idx)
        before = {p.wid for g in state.gpus.values() for p in g.placements}
        assert fabric_frag_aware_reconfigure(state, device="cpu") == []
        state.validate()
        after = {p.wid for g in state.gpus.values() for p in g.placements}
        assert after == before

    @pytest.mark.parametrize("device", KERNELS)
    def test_engine_verbs(self, device):
        tc = generate_test_case(2, n_gpus=8)
        state = tc.initial.clone()
        eng = PlacementEngine("frag_aware", fabric_device=device)
        eng.deploy(state, tc.new_workloads)
        state.validate()
        eng.compact(state)
        state.validate()
        eng.reconfigure(state)
        state.validate()


class TestPersistentMirror:
    """fleet_fabric(): one mirror per ClusterState, row-synced across calls."""

    @pytest.mark.parametrize("device", KERNELS)
    def test_reused_and_synced_after_external_mutation(self, device):
        tc = generate_test_case(1, n_gpus=8)
        state = tc.initial
        fab1 = fleet_fabric(state, device)
        fab1.feasible_all()
        gid, pl = next((g.gid, g.placements[0]) for g in state.used_gpus())
        state.gpus[gid].remove(pl.wid)
        fab2 = fleet_fabric(state, device)
        assert fab2 is fab1
        np.testing.assert_array_equal(
            fab2.feasible_all(), FleetFabric(state, device=None).feasible_all()
        )

    def test_wholesale_gpu_replacement_resyncs(self):
        tc = generate_test_case(2, n_gpus=6)
        state = tc.initial
        fleet_fabric(state, "cpu").feasible_all()
        snapshot = state.clone()
        gid = state.used_gpus()[0].gid
        state.gpus[gid].remove(state.gpus[gid].placements[0].wid)
        state.gpus = snapshot.gpus
        fab = fleet_fabric(state, "cpu")
        np.testing.assert_array_equal(
            fab.feasible_all(), FleetFabric(state, device=None).feasible_all()
        )

    def test_engine_deploys_share_one_mirror_across_calls(self):
        tc = generate_test_case(3, n_gpus=8)
        s_scalar, s_fab = tc.initial.clone(), tc.initial.clone()
        eng_off = PlacementEngine("rule_based", fabric="off", fabric_device=None)
        eng_on = PlacementEngine("rule_based", fabric="on", fabric_device="cpu")
        news = list(tc.new_workloads)
        for i, w in enumerate(news[:6]):
            eng_off.deploy(s_scalar, [w])
            eng_on.deploy(s_fab, [w])
            if i == 2:
                for st in (s_scalar, s_fab):
                    victim = st.used_gpus()[0].placements[0].wid
                    st.remove(victim)
        assert _placements(s_scalar) == _placements(s_fab)

    def test_mirror_rebuilt_when_the_device_changes(self):
        """The cached mirror serves only callers that ask for its device;
        None asks for numpy."""
        state = generate_test_case(4, n_gpus=6).initial
        on_cpu = fleet_fabric(state, "cpu")
        assert on_cpu.device == torch.device("cpu")
        assert fleet_fabric(state, torch.device("cpu")) is on_cpu
        host = fleet_fabric(state, None)
        assert host is not on_cpu and host.device is None
        assert fleet_fabric(state, None) is host
        assert fleet_fabric(state, "cpu") is not host


@pytest.mark.parametrize("device", KERNELS)
def test_empty_fleet_parity(device):
    """0-GPU cluster: fabric paths pend everything, like the scalar paths."""
    w = Workload(wid="w0", profile_id=9)
    for fn in (fabric_first_fit, fabric_load_balanced, fabric_initial_deployment,
               fabric_frag_aware_deploy):
        state = ClusterState()
        pending = fn(state, [w], device=device)
        assert [p.wid for p in pending] == ["w0"]
        assert "w0" in state.workloads
    fabric_frag_aware_compact(ClusterState(), device=device)
    assert fabric_frag_aware_reconfigure(ClusterState(), device=device) == []


@pytest.mark.parametrize("device", KERNELS)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_churn_parity(seed, device):
    """Interleaved random placements/removals keep the mirror exact."""
    rng = np.random.default_rng(seed)
    state = _random_hetero_state(seed + 100)
    fab = FleetFabric(state, device=device)
    fab.feasible_all()
    live = []
    wi = 0
    for step in range(60):
        if live and rng.random() < 0.4:
            wid, gid, pid, idx = live.pop(int(rng.integers(len(live))))
            state.remove(wid, gid)
            fab.unapply(gid, state.gpus[gid].device.profile(pid), idx)
        else:
            gid = fab.gids[int(rng.integers(len(fab.gids)))]
            device_model = state.gpus[gid].device
            pid = int(rng.choice([p.profile_id for p in device_model.profiles]))
            spot = fab.pick_first_fit(pid, device_model.name)
            if spot is None:
                continue
            sgid, idx = spot
            w = Workload(wid=f"c{wi}", profile_id=pid, device_kind=device_model.name)
            wi += 1
            state.add_workload(w)
            state.place(w.wid, sgid, idx)
            fab.apply(sgid, device_model.profile(pid), idx)
            live.append((w.wid, sgid, pid, idx))
    np.testing.assert_array_equal(
        fab.feasible_all(), FleetFabric(state, device=None).feasible_all()
    )
    state.validate()


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_slabs_equal_the_references_numpy_and_jax(ref, seed):
    """Feasibility, wastage and fragmentation slabs: the port's torch sweep
    == its numpy sweep == the reference's numpy sweep == its jitted JAX
    sweep, bit for bit, on the same mixed fleet."""
    assert ref.fabric.have_jax()
    state = _random_hetero_state(seed)
    jstate = _random_hetero_state(seed, _ref_pkg(ref))
    assert _placements(state) == _placements(jstate)
    jax_fab = ref.fabric.FleetFabric(jstate, use_jax=True)
    assert jax_fab.use_jax
    want = _slabs(jax_fab)
    for fab in (FleetFabric(state, device="cpu"), FleetFabric(state, device=None),
                ref.fabric.FleetFabric(jstate, use_jax=False)):
        for got, w in zip(_slabs(fab), want):
            assert got.dtype == w.dtype and got.shape == w.shape
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("device", KERNELS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_engine_layouts_equal_the_references(ref, seed, policy, device):
    """deploy, compact and reconfigure through the fabric: the port (either
    backend) lands the layout the reference (JAX sweeps) lands after each
    verb, with the same Table-3 metrics."""
    tc = generate_test_case(seed, n_gpus=12)
    jtc = ref.simulator.generate_test_case(seed, n_gpus=12)
    eng = PlacementEngine(policy, fabric="on", fabric_device=device)
    jeng = ref.engine.PlacementEngine(policy, fabric="on")
    state, jstate = tc.initial.clone(), jtc.initial.clone()
    assert _placements(state) == _placements(jstate)
    for verb in ("deploy", "compact", "reconfigure"):
        args = (tc.new_workloads,) if verb == "deploy" else ()
        jargs = (jtc.new_workloads,) if verb == "deploy" else ()
        res = getattr(eng, verb)(state, *args)
        jres = getattr(jeng, verb)(jstate, *jargs)
        state.validate()
        assert _placements(state) == _placements(jstate), verb
        assert [w.wid for w in res.pending] == [w.wid for w in jres.pending], verb
        assert res.committed == jres.committed, verb
    wl = list(tc.initial.workloads.values()) + list(tc.new_workloads)
    jwl = list(jtc.initial.workloads.values()) + list(jtc.new_workloads)
    from repro.core import metrics as jmetrics

    assert dataclasses.asdict(metrics.evaluate(state, tc.initial, wl)) == \
        dataclasses.asdict(jmetrics.evaluate(jstate, jtc.initial, jwl))


def _count_full_sweeps(monkeypatch):
    """Wrap the module's numpy and torch all-profile sweeps; a call over more
    than one row is a full sweep (the refresh after apply/unapply passes
    its one row)."""
    counts = {"numpy": 0, "torch": 0, "numpy_rows": 0}

    def wrap(name, key):
        real = getattr(fabric, name)

        def counted(occ, *args, **kw):
            if occ.shape[0] > 1:
                counts[key] += 1
            elif key == "numpy":
                counts["numpy_rows"] += 1
            return real(occ, *args, **kw)

        monkeypatch.setattr(fabric, name, counted)

    for name, key in (("_feasible_all_np", "numpy"), ("_score_all_np", "numpy"),
                      ("_feasible_all_torch", "torch"), ("_score_all_torch", "torch")):
        wrap(name, key)
    return counts


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_on_a_device_never_sweeps_the_fleet_in_numpy(monkeypatch, policy):
    tc = generate_test_case(1, n_gpus=12)
    counts = _count_full_sweeps(monkeypatch)
    eng = PlacementEngine(policy, fabric="on", fabric_device="cpu")
    state = tc.initial.clone()
    eng.deploy(state, tc.new_workloads)
    eng.compact(state)
    eng.reconfigure(state)
    state.validate()
    assert counts["torch"] >= 1 and counts["numpy"] == 0, counts
    if policy == "frag_aware":
        assert counts["numpy_rows"] > 0  # the row refresh stays numpy


def test_cuda_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = generate_test_case(0, n_gpus=4).initial
    w = [Workload(wid="x", profile_id=9)]
    for call in (lambda: FleetFabric(state, device="cuda"),
                 lambda: fleet_fabric(state, "cuda"),
                 lambda: fabric_first_fit(state.clone(), w, device="cuda"),
                 lambda: fabric_frag_aware_compact(state, device="cuda"),
                 lambda: PlacementEngine("frag_aware", fabric_device="cuda")):
        with pytest.raises(RuntimeError, match="no GPU"):
            call()
    assert "_fabric_mirror" not in state.__dict__


def test_every_entry_point_defaults_to_the_card(monkeypatch):
    """Named no device, the fabric, the engine and the cluster server put
    their sweeps on cuda: without a GPU each raises, and with one (faked
    here, nothing is swept) each holds ``cuda``."""
    from repro_torch.core.engine import get_policy
    from repro_torch.serving.cluster import ClusterServer

    state = generate_test_case(0, n_gpus=4).initial
    w = [Workload(wid="x", profile_id=9)]
    sweeps = (fabric_first_fit, fabric_load_balanced, fabric_initial_deployment,
              fabric_frag_aware_deploy)
    calls = [lambda: FleetFabric(state), lambda: fleet_fabric(state),
             lambda: fabric_frag_aware_compact(state),
             lambda: fabric_frag_aware_reconfigure(state),
             *[lambda fn=fn: fn(state.clone(), w) for fn in sweeps],
             lambda: PlacementEngine(), lambda: get_policy("mip"),
             lambda: ClusterServer(2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU"):
            call()
    assert "_fabric_mirror" not in state.__dict__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = torch.device("cuda")
    assert FleetFabric(state).device == cuda
    assert PlacementEngine("frag_aware").policy.fabric_device == cuda
    assert get_policy("mip").fabric_device == cuda
    assert ClusterServer(2).engine.policy.fabric_device == cuda


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_sweep_matches_numpy_at_fleet_scale():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the torch sweep runs there)")
    tc = generate_test_case(0, n_gpus=1024, device=H100_80GB)
    for got, want in zip(_slabs(FleetFabric(tc.initial, device="cuda")),
                         _slabs(FleetFabric(tc.initial, device=None))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    layouts = []
    for device in (None, "cuda"):
        state = tc.initial.clone()
        PlacementEngine("frag_aware", fabric_device=device).deploy(state, tc.new_workloads)
        state.validate()
        layouts.append(_placements(state))
    assert layouts[0] == layouts[1]
