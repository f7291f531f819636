"""The program's own telemetry (``repro_torch.obs``) beside the benchmark.

The benchmark installs no live handle: its runs, traced or not, record
nothing of the program's, so the readings of two versions of the program
compare like for like.  With a live handle installed after warm-up (as a
traced run that reads the program's spans would), a run stays correct and
the program's spans and the harness's records share one clock: each
harness step holds one ``engine.step``, each of the proxy's timed forwards
lies inside the engine's forward span and around the model's.  On the
profiler's events, the program's ranges, host-side or device-side, leave
what ``trace.reduce`` and the device readers read unchanged.
"""
import time
from types import SimpleNamespace

import pytest

from chipbench import harness, runner
from chipbench import trace as trace_mod
from chipbench.tests.support import CELLS, tiny
from repro_torch import obs
from repro_torch.serving.engine import _next_pow2

SEED = 2 ** 31 + 7


@pytest.fixture(autouse=True)
def _noop_handle():
    obs.disable()
    yield
    obs.disable()


def _run(name, traced, monkeypatch, live):
    """One small run of ``name``; with ``live``, a live handle installed
    after warm-up.  -> (result, record, the live handle or None)."""
    got = {}
    real_warm, real_drive = harness.warm_up, runner.drive

    def warm_up(*args, **kw):
        real_warm(*args, **kw)
        if live:
            got["tel"] = obs.set_telemetry(obs.Telemetry.live())

    def drive(*args, **kw):
        d = real_drive(*args, **kw)
        got["rec"] = d.record
        return d

    monkeypatch.setattr(harness, "warm_up", warm_up)
    monkeypatch.setattr(runner, "drive", drive)
    res = runner.run_cell(tiny(name), SEED, 2.0, traced, "cpu", time.perf_counter())
    return res, got["rec"], got.get("tel")


@pytest.mark.parametrize("traced", [False, True])
def test_the_benchmark_records_nothing_of_the_program(traced, monkeypatch):
    res, _, _ = _run(CELLS[0], traced, monkeypatch, live=False)
    assert res["correct"], res["checks"]
    tel = obs.get_telemetry()
    assert not tel.enabled and tel.tracer.records() == []


@pytest.mark.parametrize("name", CELLS)
def test_live_program_spans_share_the_harness_clock(name, monkeypatch):
    res, rec, tel = _run(name, True, monkeypatch, live=True)
    assert res["correct"], res["checks"]
    tr = tel.tracer
    assert tr.n_dropped == 0
    steps = rec.window_steps()
    assert steps
    eng_steps = tr.find("engine.step")
    fwd = {k: tr.find(k) for k in ("engine.prefill.forward", "engine.decode.forward")}
    models = tr.find("model.forward")
    prefills = {s.attrs["rid"]: s for s in tr.find("engine.prefill")}

    def inside(spans, a, b):
        return [s for s in spans if a <= s.t_start and s.t_end <= b]

    for st in steps:
        (es,) = inside(eng_steps, st.start, st.end)
        assert es.attrs["admitted"] == len(st.admitted)
        assert es.attrs["active"] == len(st.decode_slots)
        for kind, t0, t1, _, rows in st.spans:
            outer = "engine.prefill.forward" if kind == harness.PREFILL else "engine.decode.forward"
            (o,) = [s for s in fwd[outer] if s.t_start <= t0 and t1 <= s.t_end]
            (m,) = inside(models, t0, t1)
            assert m.parent_id == o.span_id
            if kind == harness.PREFILL:
                assert m.attrs == {"mode": "prefill", "rows": rows}
            else:
                assert m.attrs == {"mode": "decode", "rows": rows}
        for rid in st.admitted:
            p = prefills[str(rid)]
            plen = rec.requests[rid].prompt_len
            assert p.attrs["prompt_len"] == plen
            assert p.attrs["bucket"] == _next_pow2(plen)
            assert p.attrs["pad_tokens"] == _next_pow2(plen) - plen


def _ev(name, start, end, device="CPU", annotation=False):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def _events(with_program):
    """Two decode forwards of the harness (host ranges), kernels and a copy
    inside and between them; optionally the program's ranges on the host
    and their device-side annotations."""
    ev = [_ev(f"{harness.DECODE}#0", 100.0, 200.0, annotation=True),
          _ev(f"{harness.DECODE}#1", 300.0, 420.0, annotation=True),
          _ev("gemm", 110.0, 130.0, "CUDA"), _ev("decode_split_kernel", 140.0, 150.0, "CUDA"),
          _ev("Memcpy HtoD", 250.0, 255.0, "CUDA"),
          _ev("gemm", 310.0, 330.0, "CUDA"), _ev("elementwise", 335.0, 400.0, "CUDA")]
    if with_program:
        for name, a, b in (("engine.step", 50.0, 240.0), ("engine.decode", 60.0, 230.0),
                           ("engine.decode.forward", 95.0, 205.0), ("model.forward", 102.0, 198.0),
                           ("model.block", 105.0, 160.0), ("model.head", 161.0, 190.0),
                           ("engine.step", 245.0, 440.0), ("engine.decode.upload", 248.0, 256.0),
                           ("model.forward", 302.0, 410.0), ("kvcache.insert", 412.0, 415.0)):
            ev.append(_ev(name, a, b, annotation=True))
            ev.append(_ev(name, a + 3.0, b + 3.0, "CUDA", annotation=True))
    return ev


def test_program_annotations_leave_the_reduction_unchanged():
    bare = trace_mod.reduce(_events(False), 0.0005)
    full = trace_mod.reduce(_events(True), 0.0005)
    for key in ("device", "busy_s", "window_s", "device_ops", "idle_gaps"):
        assert full[key] == bare[key], key
    assert len(bare["device"]) == 5
    readings = []
    for tr in (bare, full):
        ctx = runner.Context({}, None, tr, 0.0)
        readings.append((runner.read_metric("device.idle_share", ctx),
                         runner.read_metric("dispatch.kernels_per_decode_step", ctx)))
    assert readings[0] == readings[1]
    assert readings[0][1] == 2.0  # gemm + decode, gemm + elementwise
