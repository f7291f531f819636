"""One run of one cell: set-up, the traffic, the metrics and the check.

``run_cell`` is everything ``run.py`` does after it has found the chip, so
the tests drive it on the CPU at a small size.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from typing import Any, Dict, Optional

import torch

from . import check, cost, harness, kinds, spec
from . import trace as trace_mod
from .traffic import Traffic

#: the profiler's slice: from this share of the window, for this long at most
TRACE_FROM, TRACE_SECONDS, TRACE_SHARE = 0.4, 3.0, 0.3


@dataclasses.dataclass
class Context:
    """What a metric reader reads.  ``flops``: the useful-FLOP counts of the
    configuration's kind (``kinds/<kind>.py``) unless given."""

    config: Dict[str, Any]
    record: harness.Record
    trace: Optional[Dict[str, Any]]
    setup_s: float
    flops: Any = None
    cost: Any = cost
    peaks: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.flops is None:
            self.flops = kinds.of(self.config)

    def read(self, name: str):
        """Another metric's reading, by its reader."""
        return read_metric(name, self)


def read_metric(name: str, ctx: Context):
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where the
    run gave it nothing to read."""
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"chipbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def warm_profiler(device) -> None:
    """Start and stop the profiler once around a small device op: its first
    start sets up the device tracer, which takes seconds; set-up pays it,
    not the window's slice."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(1024, device=device).sum().item()


class _Slice:
    """Starts and stops the profiler at step boundaries inside the window.
    ``program``, the program's live telemetry handle, is set aside for the
    no-op one while the profiler records: a live span opens a profiler
    range then, and the slice's readers would count what that costs."""

    def __init__(self, t_open: float, seconds: float, device, program):
        self.start_at = t_open + TRACE_FROM * seconds
        self.length = min(TRACE_SECONDS, TRACE_SHARE * seconds)
        self.device = device
        self.program = program
        self.prof = None
        self.bounds = None

    def __call__(self, now: float) -> None:
        if self.prof is None and now >= self.start_at:
            from repro_torch import obs
            from torch.profiler import ProfilerActivity, profile

            harness.sync(self.device)
            obs.set_telemetry(None)
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.bounds = (time.perf_counter(), None)
        elif self.bounds is not None and self.bounds[1] is None and \
                now >= self.bounds[0] + self.length:
            self.stop()

    def stop(self) -> None:
        if self.bounds is not None and self.bounds[1] is None:
            from repro_torch import obs

            harness.sync(self.device)
            self.bounds = (self.bounds[0], time.perf_counter())
            self.prof.stop()  # gathers the events: seconds, after the slice
            obs.set_telemetry(self.program)


@dataclasses.dataclass
class Driven:
    """One cell driven through its window: what the metrics and the check
    read."""

    record: harness.Record
    params: Dict[str, Any]
    images: Optional[torch.Tensor]
    stream: Traffic
    setup_s: float
    peak: int


def drive(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
          t_process: float) -> Driven:
    """Set up, pre-roll, then the window (the profiler's slice in it when
    ``traced``); an MoE model's routing recorded from the pre-roll on, and
    in a traced run the program's own spans, events and counters (a live
    ``repro_torch.obs`` handle from the pre-roll to the close but inside
    the profiler's slice; the handle found before is put back after).  The
    program's state is freed before this returns."""
    from repro_torch import obs

    config, mix = cell.config, cell.traffic
    arch = spec.arch_config(config)
    stream = Traffic(mix, seed, config["vocab_size"])
    params, images, engine, spans = harness.setup(config, arch, mix, seed, device, traced)
    routes = harness.Routes() if kinds.of(config).moe_layers(config) else None
    driver = harness.Driver(engine, config, mix, stream, images, spans, routes)
    if traced:
        warm_profiler(device)
    # what set-up left on the heap stays out of the collector's full passes,
    # which would otherwise pause some steps of the window and not others
    gc.collect()
    gc.freeze()
    if routes is not None:
        routes.install()
    found = obs.get_telemetry()
    program = obs.set_telemetry(obs.Telemetry.live()) if traced else None
    try:
        harness.sync(device)
        t_start = time.perf_counter()
        driver.start(t_start)
        t_open = driver.run_until(t_start + float(mix["preroll_s"]))
        setup_s = t_open - t_process
        tracer = _Slice(t_open, seconds, device, program) if traced else None
        t_close = driver.run_until(t_open + seconds, on_step=tracer)
        if tracer is not None:
            tracer.stop()
        harness.sync(device)
    finally:
        obs.set_telemetry(found)
        if routes is not None:
            routes.remove()
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    rec = driver.record(t_open, t_close)
    if tracer is not None and tracer.prof is not None:
        rec.trace = trace_mod.reduce(tracer.prof.events(), tracer.bounds[1] - tracer.bounds[0])
        rec.trace_bounds = tracer.bounds
    if program is not None:
        rec.program = harness.Program.of(program)

    # the program's state goes before the reference runs; the weights and
    # images are the benchmark's and stay
    del driver, engine
    harness.sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return Driven(rec, params, images, stream, setup_s, peak)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float) -> Dict[str, Any]:
    """Run ``cell`` once; the result line's fields, ``checks`` last."""
    d = drive(cell, seed, seconds, traced, device, t_process)
    rec, tr = d.record, d.record.trace
    ctx = Context(cell.config, rec, tr, d.setup_s,
                  peaks=json.loads((spec.HERE / "peaks.json").read_text()))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sent = [q for q in rec.requests.values() if rec.t_open <= q.sent < rec.t_close]
    failed = sum(1 for q in sent if q.tokens is not None and len(q.tokens) != q.new_tokens)

    want = int(cell.traffic["check_requests"])
    rids = check.sample(rec, seed, want)
    values = check.readings(rec, cell.config, d.params, d.images, d.stream, rids)
    checks = check.verdict(values, cell.limits, len(rids), want)
    result: Dict[str, Any] = {
        "correct": check.passed(checks),
        "attempted": len(sent),
        "failed": failed,
        "metrics": metrics,
        "device": device_info(device, cell.chips, d.peak),
    }
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [list(t) for t in tr["device_ops"]],
                               "idle_gaps": [list(t) for t in tr["idle_gaps"]]}
    result["checks"] = checks
    return result


def device_info(device, chips: int, peak: int) -> Dict[str, Any]:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": int(peak)}
