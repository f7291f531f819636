"""Kernel calibration profiler: measure what each MIG slice can serve.
Counterpart of the reference's ``obs/profile.py``, with the same presets,
problem shapes, FLOP and byte formulas, row keys and artifact schema.

The placement stack plans against :class:`repro_torch.core.perfmodel.PerfModel`,
whose built-in table has no row for the port's card.  This module runs the
port's kernel ops (``repro_torch.kernels.ops``) — flash attention (prefill),
decode attention (decode), and the SSD scan — across **MIG-profile-shaped
problem sizes** and derives measured prefill/decode service rates per
partition profile, producing:

* per-rep wall-time observations in the active :mod:`repro_torch.obs`
  metrics registry (``kernel_wall_seconds{kernel,device,profile}``
  histograms);
* a ``CALIBRATION.json``-shaped report (:data:`CALIBRATION_SCHEMA`) that
  ``PerfModel.from_calibration`` loads back into the planning stack.

The ops run on ``device``: a CUDA tensor launches the hand-written kernel,
a CPU tensor takes the plain version (``config["impl"]`` records which,
``"cuda"`` or ``"plain"``).  Inputs are float32, as in the reference, so
the byte counts are four per element.  On the card float32 selects each
kernel's CUDA-core body (``flash_attention.simt``: ``fa_fwd_kernel``;
``ssd_scan.simt``: ``ssd_kernel``), not the tensor-core bodies that the
bf16 engines run: a calibrated prefill rate is a CUDA-core float32 rate.

Slice emulation
---------------
A profile with ``c`` of the device's compute slices and ``m`` of its
memory slices gets a problem scaled to its budget: the prefill batch
scales with the compute fraction (prefill is compute-bound), the decode
batch with the memory fraction (decode bandwidth travels with the memory
slices — the MISO observation).  On a host **without** real MIG
partitions (the CPU, a whole GPU) the kernel still sees the full machine,
so measured per-token cost captures only the *shape* efficiency; the
slice's compute/memory fraction is then applied analytically
(``emulate=True``, recorded as ``emulated`` in the artifact).  On real
MIG hardware, run this same profiler inside each GPU instance with
``emulate=False`` and the fraction drops out of the measurement itself.

The sweep additionally fits an effective ``parallel_efficiency`` exponent
from the sub-whole-device measurements (``rate_p / rate_whole =
frac**e``): shape-dependent per-token overheads at small slices surface
as ``e < 1``, exactly the sublinear knob ``PerfModel`` already exposes.

Timing discipline: every measurement runs ``warmup`` discarded calls,
then times ``reps`` individual calls on the host clock, with the inputs'
device synchronised before and after each (wall time per call, host
included, as the reference's ``block_until_ready`` regimen).  Inputs come
from a seeded ``torch.Generator``, so the measured *structure* (shapes,
FLOPs, bytes, tokens) is deterministic; only wall times vary by host.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device
from . import get_telemetry
from .host import host_snapshot

log = logging.getLogger("repro_torch.obs.profile")

__all__ = [
    "CALIBRATION_SCHEMA",
    "PRESETS",
    "KernelTiming",
    "measure",
    "whole_device_specs",
    "run_calibration",
]

#: schema tag of the CALIBRATION.json artifact (validate_bench checks it).
CALIBRATION_SCHEMA = "calibration/v1"

#: problem-size presets: whole-device base shapes per kernel plus the
#: default timing discipline.  ``tiny`` is the CI smoke (seconds on one
#: CPU); ``full`` matches the historical kernel_bench shapes.
PRESETS: Dict[str, Dict[str, object]] = {
    "tiny": dict(
        flash=dict(b=2, s=256, hq=4, hkv=2, d=64),
        decode=dict(b=4, smax=256, hq=4, hkv=2, d=64),
        ssd=dict(b=2, s=256, h=2, p=16, n=8),
        reps=3, warmup=1,
    ),
    "small": dict(
        flash=dict(b=4, s=1024, hq=8, hkv=2, d=64),
        decode=dict(b=16, smax=2048, hq=8, hkv=2, d=64),
        ssd=dict(b=2, s=512, h=4, p=32, n=16),
        reps=5, warmup=2,
    ),
    "full": dict(
        flash=dict(b=8, s=2048, hq=8, hkv=2, d=64),
        decode=dict(b=32, smax=8192, hq=8, hkv=2, d=64),
        ssd=dict(b=4, s=1024, h=4, p=32, n=16),
        reps=10, warmup=3,
    ),
}

#: fitted parallel-efficiency samples are clamped here before averaging —
#: tiny-shape noise must not push the exponent out of PerfModel's (0, 1].
_EFF_CLAMP = (0.25, 1.0)


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    """numpy-style linear-interpolation percentile of pre-sorted values."""
    if not sorted_vals:
        return float("nan")
    pos = (len(sorted_vals) - 1) * (q / 100.0)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if lo == hi:
        return sorted_vals[lo]
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclasses.dataclass(frozen=True)
class KernelTiming:
    """Warm-up-disciplined wall times of one (kernel, shape) measurement."""

    wall_s: Tuple[float, ...]  # per-rep seconds, chronological

    @property
    def p50(self) -> float:
        return _pct(sorted(self.wall_s), 50.0)

    @property
    def p95(self) -> float:
        return _pct(sorted(self.wall_s), 95.0)

    def as_dict(self) -> Dict[str, float]:
        s = sorted(self.wall_s)
        return {
            "reps": len(s),
            "min": s[0],
            "mean": sum(s) / len(s),
            "p50": _pct(s, 50.0),
            "p95": _pct(s, 95.0),
        }


def _sync_fn(args) -> Callable[[], None]:
    """Waits for the device of the first CUDA tensor in ``args`` (a no-op
    when none is on a CUDA device: CPU ops return finished)."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            dev = a.device
            return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def measure(
    fn: Callable,
    *args,
    reps: int = 5,
    warmup: int = 2,
    labels: Optional[Dict[str, str]] = None,
) -> KernelTiming:
    """Time ``fn(*args)``: ``warmup`` discarded calls, then ``reps`` timed
    calls, each with the inputs' device synchronised before and after.

    Each rep is observed into the active telemetry's
    ``kernel_wall_seconds`` histogram under ``labels`` (no-op when
    telemetry is disabled — same discipline as the rest of the stack).
    """
    sync = _sync_fn(args)
    for _ in range(max(warmup, 0)):
        fn(*args)
    sync()
    tel = get_telemetry()
    hist = tel.metrics.histogram(
        "kernel_wall_seconds", "per-rep kernel wall time", labels=labels or {}
    )
    walls: List[float] = []
    for _ in range(max(reps, 1)):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        dt = time.perf_counter() - t0
        walls.append(dt)
        hist.observe(dt)
    return KernelTiming(tuple(walls))


# ---------------------------------------------------------------------------
# kernel workload specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Workload:
    """One concrete (kernel, shape): inputs, analytics, token accounting."""

    kernel: str
    shape: str
    make: Callable[[torch.device], Tuple]  # device -> (fn, args)
    tokens: int  # tokens processed per call (prefill: B*S; decode: B)
    flops: float
    bytes: float


def _randn(gen: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def _flash_workload(b: int, s: int, hq: int, hkv: int, d: int) -> _Workload:
    from ..kernels import ops

    def make(device):
        gen = torch.Generator(device=device).manual_seed(0)
        q = _randn(gen, (b, s, hq, d), device)
        k = _randn(gen, (b, s, hkv, d), device)
        v = _randn(gen, (b, s, hkv, d), device)
        return (lambda q, k, v: ops.flash_attention(q, k, v, causal=True)), (q, k, v)

    flops = 4 * b * s * s * hq * d / 2  # causal halves the score matmul
    byts = 4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    return _Workload("flash_attention", f"B{b}xS{s}xH{hq}/{hkv}xD{d}",
                     make, b * s, flops, byts)


def _decode_workload(b: int, smax: int, hq: int, hkv: int, d: int) -> _Workload:
    from ..kernels import ops

    def make(device):
        gen = torch.Generator(device=device).manual_seed(0)
        q = _randn(gen, (b, 1, hq, d), device)
        k = _randn(gen, (b, smax, hkv, d), device)
        v = _randn(gen, (b, smax, hkv, d), device)
        lens = torch.full((b,), smax // 2, dtype=torch.int32, device=device)
        return ops.decode_attention, (q, k, v, lens)

    flops = 4.0 * b * smax * hq * d
    byts = 4.0 * (2 * b * hq * d + 2 * b * smax * hkv * d) + 4.0 * b
    return _Workload("decode_attention", f"B{b}xS{smax}ragged",
                     make, b, flops, byts)


def _ssd_workload(b: int, s: int, h: int, p: int, n: int) -> _Workload:
    """The reference scans in ``chunk = min(256, s)`` steps; the port's scan
    fixes its own 64-step chunk, and the FLOP count does not depend on it."""
    from ..kernels import ops

    def make(device):
        gen = torch.Generator(device=device).manual_seed(0)
        x = _randn(gen, (b, s, h, p), device)
        dt = torch.nn.functional.softplus(_randn(gen, (b, s, h), device))
        A = -torch.ones((h,), dtype=torch.float32, device=device)
        B_ = _randn(gen, (b, s, n), device)
        C = _randn(gen, (b, s, n), device)
        return ops.ssd_scan, (x, dt, A, B_, C)

    flops = 2.0 * b * s * h * p * n * 2
    byts = 4.0 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + b * h * p * n)
    return _Workload("ssd_scan", f"B{b}xS{s}xH{h}xP{p}xN{n}",
                     make, b * s, flops, byts)


def whole_device_specs(preset: str = "full") -> List[_Workload]:
    """The preset's whole-device workloads."""
    cfg = PRESETS[preset]
    return [
        _flash_workload(**cfg["flash"]),
        _decode_workload(**cfg["decode"]),
        _ssd_workload(**cfg["ssd"]),
    ]


def _scaled(base: int, frac: float) -> int:
    return max(1, round(base * frac))


# ---------------------------------------------------------------------------
# the profile sweep
# ---------------------------------------------------------------------------
def _sweep_profiles(device) -> List:
    """Profiles to measure: distinct (compute, memory) footprints, big->small
    (the ``+me`` variant duplicates its base profile's budget — skip it)."""
    seen = set()
    out = []
    for prof in device.profiles_sorted_desc():
        key = (prof.compute_slices, prof.memory_slices)
        if key in seen:
            continue
        seen.add(key)
        out.append(prof)
    return out


def _timing_row(wl: _Workload, device_name: str, prof, cfrac: float,
                mfrac: float, reps: int, warmup: int,
                torch_device: torch.device) -> Dict[str, object]:
    fn, args = wl.make(torch_device)
    timing = measure(
        fn, *args, reps=reps, warmup=warmup,
        labels={"kernel": wl.kernel, "device": device_name, "profile": prof.name},
    )
    p50 = timing.p50
    return {
        "kernel": wl.kernel,
        "device": device_name,
        "profile_id": prof.profile_id,
        "profile": prof.name,
        "compute_frac": cfrac,
        "memory_frac": mfrac,
        "shape": wl.shape,
        "tokens": wl.tokens,
        "flops": wl.flops,
        "bytes": wl.bytes,
        "wall_s": timing.as_dict(),
        "tokens_per_s": wl.tokens / p50 if p50 > 0 else float("nan"),
        "achieved_gflops_per_s": wl.flops / p50 / 1e9 if p50 > 0 else float("nan"),
        "achieved_gbytes_per_s": wl.bytes / p50 / 1e9 if p50 > 0 else float("nan"),
    }


def _fit_efficiency(samples: List[Tuple[float, float]]) -> float:
    """Effective parallel-efficiency exponent from (frac, eff_ratio) pairs,
    where ``eff_ratio`` is the slice-shaped run's per-token rate over the
    whole-device per-token rate: ``rate_p/rate_whole = frac**e`` with the
    fraction applied analytically gives ``e = 1 + ln(eff)/ln(frac)``."""
    es = []
    for frac, eff in samples:
        if not (0.0 < frac < 1.0) or not (eff > 0.0) or not math.isfinite(eff):
            continue
        e = 1.0 + math.log(eff) / math.log(frac)
        es.append(min(max(e, _EFF_CLAMP[0]), _EFF_CLAMP[1]))
    if not es:
        return 1.0
    return sum(es) / len(es)


def profile_device(
    device,
    preset: str = "small",
    reps: Optional[int] = None,
    warmup: Optional[int] = None,
    emulate: bool = True,
    torch_device: Union[str, torch.device] = "cuda",
) -> Tuple[Dict[str, object], List[Dict[str, object]]]:
    """Measure one device model across its profile ladder, running the ops
    on ``torch_device``.

    Returns ``(device_entry, kernel_rows)``: the former is the
    ``devices[<name>]`` section of the calibration artifact (whole-device
    rates, per-profile rates, fitted ``parallel_efficiency``), the latter
    the raw per-(kernel, profile) measurement rows.
    """
    torch_device = resolve_device(torch_device)
    cfg = PRESETS[preset]
    reps = int(cfg["reps"] if reps is None else reps)
    warmup = int(cfg["warmup"] if warmup is None else warmup)
    flash, decode, ssd = cfg["flash"], cfg["decode"], cfg["ssd"]

    rows: List[Dict[str, object]] = []
    profiles_entry: Dict[str, Dict[str, object]] = {}
    whole: Dict[str, float] = {}
    eff_samples: List[Tuple[float, float]] = []
    whole_rate: Dict[str, float] = {}  # kernel -> whole-device tokens/s (raw)

    for prof in _sweep_profiles(device):
        cfrac = prof.compute_slices / device.n_gpu_slices
        mfrac = prof.memory_slices / device.n_memory_slices
        workloads = (
            _flash_workload(**{**flash, "b": _scaled(flash["b"], cfrac)}),
            _decode_workload(**{**decode, "b": _scaled(decode["b"], mfrac)}),
            _ssd_workload(**{**ssd, "b": _scaled(ssd["b"], cfrac)}),
        )
        log.info("profiling %s / %s (c=%d/%d m=%d/%d) ...",
                 device.name, prof.name, prof.compute_slices,
                 device.n_gpu_slices, prof.memory_slices,
                 device.n_memory_slices)
        by_kernel: Dict[str, Dict[str, object]] = {}
        for wl in workloads:
            row = _timing_row(wl, device.name, prof, cfrac, mfrac, reps, warmup,
                              torch_device)
            rows.append(row)
            by_kernel[wl.kernel] = row

        raw_prefill = float(by_kernel["flash_attention"]["tokens_per_s"])
        raw_decode = float(by_kernel["decode_attention"]["tokens_per_s"])
        # on non-MIG hosts the kernel saw the whole machine: apply the
        # slice's fraction analytically (see module docstring).
        prefill_tps = raw_prefill * (cfrac if emulate else 1.0)
        decode_tps = raw_decode * (mfrac if emulate else 1.0)
        is_whole = (prof.compute_slices == device.n_gpu_slices)
        if is_whole:
            whole = {
                "prefill_tokens_per_s": prefill_tps,
                "decode_tokens_per_s": decode_tps,
            }
            whole_rate = {"prefill": raw_prefill, "decode": raw_decode}
        else:
            if whole_rate.get("prefill"):
                eff_samples.append((cfrac, raw_prefill / whole_rate["prefill"]))
            if whole_rate.get("decode"):
                eff_samples.append((mfrac, raw_decode / whole_rate["decode"]))
        profiles_entry[str(prof.profile_id)] = {
            "name": prof.name,
            "compute_frac": cfrac,
            "memory_frac": mfrac,
            "prefill_tokens_per_s": prefill_tps,
            "decode_tokens_per_s": decode_tps,
        }

    entry = {
        "whole_device": whole,
        "parallel_efficiency": _fit_efficiency(eff_samples),
        "emulated": emulate,
        "profiles": profiles_entry,
    }
    return entry, rows


def run_calibration(
    devices: Optional[Sequence] = None,
    preset: str = "small",
    reps: Optional[int] = None,
    warmup: Optional[int] = None,
    emulate: bool = True,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, object]:
    """The full calibration sweep -> a ``CALIBRATION.json``-shaped dict.

    ``devices`` are device models (default ``[H100_80GB]``, the port's
    card); ``device`` is the torch device the ops run on (default
    ``cuda``, which raises without a GPU).  Write the report with
    ``obs.write_report(path, report, CALIBRATION_SCHEMA)`` (the
    ``repro_torch.launch.calibrate`` CLI does exactly that) and load it
    back with ``PerfModel.from_calibration(path)``.
    """
    from ..core.profiles import H100_80GB

    torch_device = resolve_device("cuda" if device is None else device)
    devices = list(devices) if devices else [H100_80GB]
    host = host_snapshot()

    report: Dict[str, object] = {
        "config": {
            "preset": preset,
            "reps": reps if reps is not None else PRESETS[preset]["reps"],
            "warmup": warmup if warmup is not None else PRESETS[preset]["warmup"],
            "emulated": emulate,
            "impl": "cuda" if torch_device.type == "cuda" else "plain",
            "devices": [d.name for d in devices],
        },
        "host": host,
        "devices": {},
        "kernels": [],
    }
    for dev_model in devices:
        entry, rows = profile_device(
            dev_model, preset=preset, reps=reps, warmup=warmup, emulate=emulate,
            torch_device=torch_device,
        )
        report["devices"][dev_model.name] = entry
        report["kernels"].extend(rows)
    return report
