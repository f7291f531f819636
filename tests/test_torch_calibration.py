"""Port calibration profiler vs the reference: ``repro_torch.obs.profile``
and its CLI twin ``repro_torch.launch.calibrate`` against ``repro.obs.profile``
and ``benchmarks/calibrate.py``.

On the CPU the port runs the plain versions and the reference its jnp path,
both at the ``tiny`` preset with one rep and no warm-up.  Wall times differ
by nature; everything else in a row (shapes, tokens, FLOPs, bytes, profile
ids, names and fractions) must be equal, and so must the per-rep telemetry
counts.  The reference's ``TestProfilerSweep`` cases and
``test_measure_records_obs_histograms`` run on the port.  The ``gpu`` tests
sweep through the hand-written kernels on the card:
    python -m pytest -q -m gpu tests/test_torch_calibration.py

The reference package is imported inside the CPU tests only, so the ``gpu``
tests also run where JAX is not installed.  Every test leaves both
packages' telemetry disabled and writes only under ``tmp_path``.
"""
import json
import math
import sys

import pytest
import torch

from repro_torch import obs as tobs
from repro_torch.core import profiles as tprofiles
from repro_torch.core.perfmodel import PerfModel
from repro_torch.kernels import ops
from repro_torch.launch import calibrate as tcalibrate
from repro_torch.obs import profile as tprofile

TINY = dict(preset="tiny", reps=1, warmup=0)
#: row keys that hold a measurement (wall time and what is derived from it)
TIMED = {"wall_s", "tokens_per_s", "achieved_gflops_per_s", "achieved_gbytes_per_s"}
PARITY_DEVICES = ["A100-80GB", "H100-96GB"]
LADDER = [0, 5, 9, 14, 15, 19]


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    yield
    tobs.disable()
    ref_obs = sys.modules.get("repro.obs")
    if ref_obs is not None:
        ref_obs.disable()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _tdevice(name):
    return {d.name: d for d in (tprofiles.A100_80GB, tprofiles.H100_96GB,
                                tprofiles.H100_80GB)}[name]


@pytest.fixture(scope="module")
def sweeps():
    """One tiny sweep per package over A100_80GB and H100_96GB, each under
    its own live telemetry (restored afterwards), plus the port's default
    sweep (H100_80GB)."""
    from repro import obs as robs
    from repro.core.profiles import A100_80GB, H100_96GB
    from repro.obs import profile as rprofile

    with robs.enabled() as rtel:
        ref = rprofile.run_calibration([A100_80GB, H100_96GB], **TINY)
    with tobs.enabled() as ttel:
        port = tprofile.run_calibration([_tdevice(n) for n in PARITY_DEVICES],
                                        device="cpu", **TINY)
    port_default = tprofile.run_calibration(device="cpu", **TINY)
    return dict(ref=ref, port=port, port_default=port_default, ref_tel=rtel, port_tel=ttel)


def _untimed(row):
    return {k: v for k, v in row.items() if k not in TIMED}


# ---------------------------------------------------------------------------
# structural parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", PARITY_DEVICES)
def test_rows_equal_the_reference_but_for_timings(sweeps, device):
    ref = [r for r in sweeps["ref"]["kernels"] if r["device"] == device]
    port = [r for r in sweeps["port"]["kernels"] if r["device"] == device]
    assert len(ref) == len(port) == 18  # 6 distinct profiles x 3 kernels
    for r, p in zip(ref, port):
        assert set(r) == set(p)
        assert _untimed(p) == _untimed(r)
        assert set(p["wall_s"]) == set(r["wall_s"])
        assert p["wall_s"]["reps"] == 1 and p["wall_s"]["p50"] > 0
        assert p["tokens_per_s"] == pytest.approx(p["tokens"] / p["wall_s"]["p50"])


@pytest.mark.parametrize("device", PARITY_DEVICES)
def test_device_entries_equal_the_reference_but_for_rates(sweeps, device):
    ref = sweeps["ref"]["devices"][device]
    port = sweeps["port"]["devices"][device]
    assert set(port) == set(ref)
    assert port["emulated"] == ref["emulated"] is True
    assert set(port["whole_device"]) == set(ref["whole_device"])
    assert list(port["profiles"]) == list(ref["profiles"]) == [str(p) for p in LADDER]
    for pid, r in ref["profiles"].items():
        p = port["profiles"][pid]
        assert set(p) == set(r)
        for key in ("name", "compute_frac", "memory_frac"):
            assert p[key] == r[key]
        assert p["prefill_tokens_per_s"] > 0 and p["decode_tokens_per_s"] > 0
    assert 0.0 < port["parallel_efficiency"] <= 1.0


def test_config_equals_the_reference_but_for_impl(sweeps):
    ref, port = dict(sweeps["ref"]["config"]), dict(sweeps["port"]["config"])
    assert (ref.pop("impl"), port.pop("impl")) == ("jnp", "plain")
    assert port == ref
    assert set(sweeps["port"]) == set(sweeps["ref"])
    assert set(sweeps["port"]["host"]) == set(sweeps["ref"]["host"])


def test_default_device_is_the_h100_80gb_as_the_reference_sweeps_the_a100(sweeps):
    """The two ladders are the same MIG geometry: the port's default sweep
    equals the reference's A100_80GB rows but for the device name."""
    port = sweeps["port_default"]
    assert port["config"]["devices"] == ["H100-80GB"]
    ref = [r for r in sweeps["ref"]["kernels"] if r["device"] == "A100-80GB"]
    assert len(port["kernels"]) == len(ref)
    for r, p in zip(ref, port["kernels"]):
        assert p["device"] == "H100-80GB"
        assert _untimed(p) == {**_untimed(r), "device": "H100-80GB"}
    ref_profiles = sweeps["ref"]["devices"]["A100-80GB"]["profiles"]
    for pid, p in port["devices"]["H100-80GB"]["profiles"].items():
        assert (p["name"], p["compute_frac"], p["memory_frac"]) == (
            ref_profiles[pid]["name"], ref_profiles[pid]["compute_frac"],
            ref_profiles[pid]["memory_frac"])


def test_whole_device_specs_equal_the_references():
    from repro.obs import profile as rprofile

    for preset in tprofile.PRESETS:
        ref, port = rprofile.whole_device_specs(preset), tprofile.whole_device_specs(preset)
        assert [(w.kernel, w.shape, w.tokens, w.flops, w.bytes) for w in port] == \
            [(w.kernel, w.shape, w.tokens, w.flops, w.bytes) for w in ref]


def test_presets_and_constants_equal_the_references():
    from repro.obs import profile as rprofile

    assert tprofile.PRESETS == rprofile.PRESETS
    assert tprofile.CALIBRATION_SCHEMA == rprofile.CALIBRATION_SCHEMA == "calibration/v1"
    assert tprofile._EFF_CLAMP == rprofile._EFF_CLAMP
    for base in (1, 2, 4, 8, 16, 32):
        for frac in (1 / 8, 1 / 7, 2 / 7, 3 / 8, 3 / 7, 0.5, 4 / 7, 1.0):
            assert tprofile._scaled(base, frac) == rprofile._scaled(base, frac)


@pytest.mark.parametrize("name", PARITY_DEVICES + ["H100-80GB"])
def test_sweep_profiles_equal_the_references(name):
    from repro.core import profiles as rprofiles
    from repro.obs import profile as rprofile

    rdev = {"A100-80GB": rprofiles.A100_80GB, "H100-96GB": rprofiles.H100_96GB,
            "H100-80GB": rprofiles.A100_80GB}[name]  # the same MIG geometry
    got = [(p.profile_id, p.name) for p in tprofile._sweep_profiles(_tdevice(name))]
    assert got == [(p.profile_id, p.name) for p in rprofile._sweep_profiles(rdev)]
    assert [pid for pid, _ in got] == LADDER


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vals,q", [
    ([], 50.0), ([3.0], 50.0), ([1.0, 2.0], 50.0), ([1.0, 2.0, 4.0], 95.0),
    ([0.5, 0.7, 0.9, 1.3, 8.0], 50.0), ([0.5, 0.7, 0.9, 1.3, 8.0], 95.0),
    ([0.5, 0.7, 0.9, 1.3, 8.0], 0.0), ([0.5, 0.7, 0.9, 1.3, 8.0], 100.0),
])
def test_pct_equals_the_references(vals, q):
    from repro.obs import profile as rprofile

    got, want = tprofile._pct(vals, q), rprofile._pct(vals, q)
    assert (math.isnan(got) and math.isnan(want)) or got == want


@pytest.mark.parametrize("samples", [
    [], [(1.0, 0.5)], [(0.0, 0.5)], [(0.5, 0.0)], [(0.5, float("nan"))],
    [(0.5, 0.5)], [(3 / 7, 0.9), (0.5, 1.2)], [(1 / 7, 1e-6), (1 / 8, 50.0)],
    [(2 / 7, 0.7), (0.25, 0.8), (1 / 7, 0.3), (0.125, 0.95)],
])
def test_fit_efficiency_equals_the_references(samples):
    from repro.obs import profile as rprofile

    got = tprofile._fit_efficiency(samples)
    assert got == rprofile._fit_efficiency(samples)
    assert 0.0 < got <= 1.0


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def _hist_counts(tel):
    return {inst.labels: inst.count
            for inst in tel.metrics.families().get("kernel_wall_seconds", [])}


def test_kernel_wall_histograms_equal_the_references(sweeps):
    ref, port = _hist_counts(sweeps["ref_tel"]), _hist_counts(sweeps["port_tel"])
    assert port == ref
    assert sum(port.values()) == len(sweeps["port"]["kernels"]) * TINY["reps"]


# ---------------------------------------------------------------------------
# artifact: validator and PerfModel, across packages
# ---------------------------------------------------------------------------
def test_validate_bench_accepts_the_ports_artifact(sweeps, tmp_path):
    from benchmarks import validate_bench

    path = tmp_path / "CALIBRATION.json"
    assert tobs.write_report(str(path), sweeps["port"], tprofile.CALIBRATION_SCHEMA)
    assert validate_bench.validate(str(path)) == []


@pytest.mark.parametrize("source", ["ref", "port"])
def test_perfmodels_read_either_report_to_the_same_rates(sweeps, source):
    from repro.core import profiles as rprofiles
    from repro.core.perfmodel import PerfModel as RefPerfModel

    rep = json.loads(json.dumps({**sweeps[source], "schema": "calibration/v1"}))
    ref_pm, port_pm = RefPerfModel.from_calibration(rep), PerfModel.from_calibration(rep)
    assert port_pm.parallel_efficiency == ref_pm.parallel_efficiency
    for name, rdev in (("A100-80GB", rprofiles.A100_80GB), ("H100-96GB", rprofiles.H100_96GB)):
        for pid in LADDER:
            assert port_pm.rates(_tdevice(name), pid) == ref_pm.rates(rdev, pid)


# ---------------------------------------------------------------------------
# the reference's sweep cases (tests/test_calibration.py), on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_artifact(tmp_path_factory):
    """One tiny sweep through the CLI twin, shared by the round-trip tests."""
    out = tmp_path_factory.mktemp("cal") / "CALIBRATION.json"
    rc = tcalibrate.main(["--torch-device", "cpu", "--preset", "tiny", "--reps", "1",
                          "--warmup", "0", "--out", str(out)])
    assert rc == 0
    return out


class TestProfilerSweep:
    def test_artifact_is_schema_valid(self, tiny_artifact):
        from benchmarks import validate_bench

        assert validate_bench.validate(str(tiny_artifact)) == []

    def test_round_trip_into_perfmodel(self, tiny_artifact):
        rep = json.loads(tiny_artifact.read_text())
        assert rep["schema"] == "calibration/v1"
        assert rep["config"]["impl"] == "plain"
        pm = PerfModel.from_calibration(tiny_artifact)
        whole = rep["devices"]["H100-80GB"]["whole_device"]
        tp = pm.device_throughput(tprofiles.H100_80GB)
        assert tp.prefill_tokens_per_s == pytest.approx(whole["prefill_tokens_per_s"])
        assert tp.decode_tokens_per_s == pytest.approx(whole["decode_tokens_per_s"])
        assert 0.0 < pm.parallel_efficiency <= 1.0
        # monotone through the model: bigger profiles never serve slower
        rates = [pm.rates(tprofiles.H100_80GB, pid) for pid in LADDER]
        for (p_big, d_big), (p_small, d_small) in zip(rates, rates[1:]):
            assert p_big >= p_small and d_big >= d_small

    def test_sweep_covers_distinct_profiles_and_kernels(self, tiny_artifact):
        rows = json.loads(tiny_artifact.read_text())["kernels"]
        assert {r["kernel"] for r in rows} == {"flash_attention", "decode_attention", "ssd_scan"}
        # the H100 80GB ladder has 6 distinct (compute, memory) footprints
        assert {r["profile_id"] for r in rows} == set(LADDER)
        for r in rows:
            assert r["wall_s"]["p50"] > 0
            assert r["flops"] > 0 and r["bytes"] > 0

    def test_problem_sizes_scale_with_slice_budget(self, tiny_artifact):
        rep = json.loads(tiny_artifact.read_text())
        by_prof = {r["profile_id"]: r for r in rep["kernels"]
                   if r["kernel"] == "flash_attention"}
        # prefill batch shrinks with the compute fraction: 7g does 2x256
        # tokens per call at the tiny preset, 1g does 1x256
        assert by_prof[0]["tokens"] == 2 * 256
        assert by_prof[19]["tokens"] == 1 * 256

    def test_measure_records_obs_histograms(self):
        with tobs.enabled() as tel:
            timing = tprofile.measure(
                lambda x: x + 1.0, 1.0, reps=3, warmup=1,
                labels={"kernel": "dummy", "device": "t", "profile": "p"},
            )
        assert len(timing.wall_s) == 3
        hist = tel.metrics.get(
            "kernel_wall_seconds",
            labels={"kernel": "dummy", "device": "t", "profile": "p"},
        )
        assert hist is not None and hist.count == 3


def test_cli_telemetry_and_device_models(tmp_path):
    out = tmp_path / "cal.json"
    assert tcalibrate.main(["--torch-device", "cpu", "--device", "A100-80GB", "H100-96GB",
                            "--preset", "tiny", "--reps", "1", "--warmup", "0", "--no-emulate",
                            "--telemetry", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["config"]["devices"] == PARITY_DEVICES and rep["config"]["emulated"] is False
    prom = (tmp_path / "cal.json.prom").read_text()
    assert prom.count('repro_kernel_wall_seconds_count{') == len(rep["kernels"])
    assert not tobs.get_telemetry().enabled  # the CLI disabled what it enabled


def test_run_calibration_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tprofile.run_calibration(**TINY)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_sweep_on_the_card_runs_the_kernels(cuda):
    ops.reset_launch_counts()
    rep = tprofile.run_calibration(preset="tiny", reps=2, warmup=1, device=cuda)
    counts = ops.launch_counts()
    assert rep["config"]["impl"] == "cuda"
    # 6 profiles x (1 warm-up + 2 reps), f32: the CUDA-core flash and SSD bodies
    for name in ("flash_attention", "flash_attention.simt", "decode_attention", "ssd_scan",
                 "ssd_scan.simt"):
        assert counts.get(name, 0) == 18, (name, counts)
    assert counts.get("decode_attention_q8", 0) == 0
    pm = PerfModel.from_calibration({**rep, "schema": "calibration/v1"})
    assert 0.0 < pm.parallel_efficiency <= 1.0
    for r in rep["kernels"]:
        assert r["wall_s"]["p50"] > 0 and math.isfinite(r["tokens_per_s"])
