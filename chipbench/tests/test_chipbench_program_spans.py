"""The program's own telemetry (``repro_torch.obs``) beside the benchmark.

An untraced run, which gives the end-to-end metrics, keeps the program's
no-op handle: it records nothing of the program's.  A traced run installs
a live handle after warm-up, sets it aside for the no-op one while the
profiler records, keeps what it recorded on its ``Record`` (``program``)
and puts the handle it found back.  The program's spans and the harness's
records share one clock: each harness step outside the profiler's slice
holds one ``engine.step``, each of the proxy's timed forwards lies inside
the engine's forward span and around the model's.  On the profiler's events,
the program's ranges, host-side or device-side, leave what
``trace.reduce`` and the device readers read unchanged.
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


def _run(name, traced, monkeypatch):
    """One small run of ``name`` -> (result, record)."""
    got = {}
    real_drive = runner.drive

    def drive(*args, **kw):
        d = real_drive(*args, **kw)
        got["rec"] = d.record
        return d

    monkeypatch.setattr(runner, "drive", drive)
    res = runner.run_cell(tiny(name), SEED, 2.0, traced, "cpu", time.perf_counter())
    return res, got["rec"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_benchmark_records_nothing_of_the_program(traced, monkeypatch):
    """Nothing is left in the program's process-global handle: a traced
    run's records are the run's own, untraced runs keep none."""
    res, rec = _run(CELLS[0], traced, monkeypatch)
    assert res["correct"], res["checks"]
    tel = obs.get_telemetry()
    assert not tel.enabled and tel.tracer.records() == []
    assert (rec.program is not None) == traced
    assert ("dispatch.decode_host_ms" in res["metrics"]) == traced


@pytest.mark.parametrize("name", CELLS)
def test_live_program_spans_share_the_harness_clock(name, monkeypatch):
    res, rec = _run(name, True, monkeypatch)
    assert res["correct"], res["checks"]
    prog = rec.program
    assert prog.n_dropped == 0
    steps = rec.window_steps()
    assert steps

    def find(name):
        return [s for s in prog.spans if s.name == name]

    eng_steps = find("engine.step")
    fwd = {k: find(k) for k in ("engine.prefill.forward", "engine.decode.forward")}
    models = find("model.forward")
    prefills = {s.attrs["rid"]: s for s in find("engine.prefill")}

    def inside(spans, a, b):
        return [s for s in spans if a <= s.t_start and s.t_end <= b]

    a, b = rec.trace_bounds
    assert not inside(prog.spans, a, b)  # nothing recorded while the profiler recorded
    assert [s for s in prog.spans if s.t_end < a] and [s for s in prog.spans if s.t_start > b]
    outside = [st for st in steps if st.end < a or st.start > b]
    assert len(outside) < len(steps)
    for st in outside:
        (es,) = inside(eng_steps, st.start, st.end)
        assert es.attrs["admitted"] == len(st.admitted)
        assert es.attrs["active"] == len(st.decode_slots)
        for kind, t0, t1, _, rows in st.spans:
            outer = "engine.prefill.forward" if kind == harness.PREFILL else "engine.decode.forward"
            (o,) = [s for s in fwd[outer] if s.t_start <= t0 and t1 <= s.t_end]
            (m,) = inside(models, t0, t1)
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
    # the counters as the program keeps them: every prefill since the pre-roll
    pre = find("engine.prefill")
    assert prog.counters["engine_prefill_tokens_total"] == sum(s.attrs["bucket"] for s in pre)
    submits = [e for e in prog.events if e.name == "engine.submit"]
    assert submits and not [e for e in submits if a <= e.time <= b]
    for e in submits:
        assert e.attrs["prompt_len"] == rec.requests[int(e.attrs["rid"])].prompt_len


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


def _program_record(n_dropped=0):
    """Window [10, 20), the profiler's slice [14, 15): decode forwards of
    50, 70 and 60 ms outside the slice; one inside it, one before the
    window, one across its close, and a prefill forward, all left out."""
    S = harness.ProgramSpan
    spans = [S("model.forward", 9.0, 9.03, {"mode": "decode", "rows": 2}),
             S("model.forward", 11.0, 11.05, {"mode": "decode", "rows": 2}),
             S("model.block", 11.0, 11.01, {"layer": 0, "kind": "attn"}),
             S("model.forward", 12.0, 12.07, {"mode": "decode", "rows": 2}),
             S("model.forward", 13.0, 13.5, {"mode": "prefill", "rows": 1024}),
             S("model.forward", 14.5, 14.6, {"mode": "decode", "rows": 2}),
             S("model.forward", 14.98, 15.02, {"mode": "decode", "rows": 2}),
             S("model.forward", 16.0, 16.06, {"mode": "decode", "rows": 2}),
             S("model.forward", 19.99, 20.1, {"mode": "decode", "rows": 2})]
    rec = harness.Record({"n_layers": 1}, {}, 2, 256, 10.0, 20.0, {}, [], {}, {})
    rec.trace_bounds = (14.0, 15.0)
    rec.program = harness.Program(spans, [], {}, n_dropped)
    return rec


def test_decode_host_ms_is_the_median_decode_forward_outside_the_slice():
    rec = _program_record()
    ctx = runner.Context(rec.config, rec, None, 0.0)
    assert runner.read_metric("dispatch.decode_host_ms", ctx) == pytest.approx(60.0)


@pytest.mark.parametrize("why", ["dropped", "untraced", "no decode"])
def test_decode_host_ms_reads_nothing_without_whole_records(why):
    rec = _program_record(n_dropped=3 if why == "dropped" else 0)
    if why == "untraced":
        rec.program = None
    if why == "no decode":
        rec.program.spans = [s for s in rec.program.spans if s.attrs.get("mode") != "decode"]
    ctx = runner.Context(rec.config, rec, None, 0.0)
    assert runner.read_metric("dispatch.decode_host_ms", ctx) is None
