"""Per-partition service-rate model: what a placed replica can actually serve.

Placement decides *where* a replica lives; this module decides *how fast* it
runs there, closing the loop between slice geometry and request traffic.
LLM inference has two phases with different bottlenecks:

  * **prefill** is compute-bound  -> throughput scales with the partition's
    share of compute slices (MIG SMs / pod rows);
  * **decode** is bandwidth-bound -> throughput scales with the partition's
    share of memory slices (MIG memory carries its HBM controllers with it,
    so bandwidth is proportional to memory slices — the MISO observation).

``PerfModel.rates(device, profile_id)`` therefore maps a whole-device
throughput pair to per-profile (prefill tokens/s, decode tokens/s) via the
profile's compute/memory fractions, optionally raised to a
``parallel_efficiency`` exponent <= 1 (sublinear scaling of small slices;
still monotone: a bigger slice never serves slower).  Whole-device numbers
come from a user calibration dict, a ``calibrator`` hook, or a built-in
table, in that order — measurements outrank planning numbers.  The kernel
calibration profiler (the reference's ``obs/profile.py``)
produces a ``CALIBRATION.json`` artifact that
:meth:`PerfModel.from_calibration` loads straight into the calibration
dict, so autoscaling and SLO attainment can plan on measured rates.

This is the port's copy of ``repro/core/perfmodel.py``.  ``DEVICE_THROUGHPUT``
holds the reference's round planning numbers, copied for parity; none of
them is a measured rate of any device.  It has no row for ``H100-80GB``:
a rate for that card comes from calibrating the port's kernels on it (the
calibration profiler is not ported yet), so until then the per-memory-GB
fallback below applies to it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

from .profiles import DeviceModel

__all__ = [
    "DeviceThroughput",
    "DEVICE_THROUGHPUT",
    "PerfModel",
]


@dataclasses.dataclass(frozen=True)
class DeviceThroughput:
    """Aggregate serving throughput of one WHOLE device (all slices)."""

    prefill_tokens_per_s: float
    decode_tokens_per_s: float

    def scaled(self, prefill_frac: float, decode_frac: float) -> "DeviceThroughput":
        return DeviceThroughput(
            prefill_tokens_per_s=self.prefill_tokens_per_s * prefill_frac,
            decode_tokens_per_s=self.decode_tokens_per_s * decode_frac,
        )


#: built-in whole-device throughputs for a mid-size (~10B-class) serving
#: model — the reference's round planning numbers, not measurements; calibrate
#: with real ones via ``PerfModel(calibration=...)`` or the roofline hook.
DEVICE_THROUGHPUT: Dict[str, DeviceThroughput] = {
    "A100-80GB": DeviceThroughput(20_000.0, 2_000.0),
    "H100-96GB": DeviceThroughput(50_000.0, 4_500.0),
    # a 16x16 v5e pod aggregates 256 chips; decode is per-pod aggregate.
    "TPUv5e-16x16-pod": DeviceThroughput(400_000.0, 60_000.0),
}

#: fallback for unknown devices: scale a conservative per-memory-GB rate.
_FALLBACK_PER_GB = DeviceThroughput(150.0, 15.0)


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """Profile -> service-rate mapping with optional calibration.

    Throughput sources, highest precedence first:

    1. ``calibration`` — explicit measured table per device name
       (``PerfModel.from_calibration`` builds one from the profiler's
       ``CALIBRATION.json``);
    2. ``calibrator`` — a measurement hook (e.g. the kernel profiler or a
       roofline pass), consulted once per device and cached.  A supplied
       hook *beats the built-in table*: measurements outrank the
       hand-written planning numbers;
    3. the built-in ``DEVICE_THROUGHPUT`` table;
    4. a conservative per-memory-GB fallback for unknown devices.
    """

    calibration: Optional[Dict[str, DeviceThroughput]] = None
    calibrator: Optional[Callable[[DeviceModel], DeviceThroughput]] = None
    #: slice-count scaling exponent in (0, 1]: 1.0 = linear; lower models
    #: sublinear parallel efficiency of large partitions.  Monotone for any
    #: value > 0 (bigger fraction => >= throughput).
    parallel_efficiency: float = 1.0

    def __post_init__(self) -> None:
        if not 0.0 < self.parallel_efficiency <= 1.0:
            raise ValueError(
                f"parallel_efficiency must be in (0, 1], "
                f"got {self.parallel_efficiency}"
            )

    # -- whole-device -------------------------------------------------------
    def device_throughput(self, device: DeviceModel) -> DeviceThroughput:
        if self.calibration and device.name in self.calibration:
            return self.calibration[device.name]
        cache = self.__dict__.setdefault("_hook_cache", {})
        if self.calibrator is not None:
            if device.name not in cache:
                cache[device.name] = self.calibrator(device)
            return cache[device.name]
        if device.name in DEVICE_THROUGHPUT:
            return DEVICE_THROUGHPUT[device.name]
        if device.name not in cache:
            gb = float(getattr(device, "mem_per_slice_gb", 10) or 10)
            total_gb = gb * device.n_memory_slices
            cache[device.name] = _FALLBACK_PER_GB.scaled(total_gb, total_gb)
        return cache[device.name]

    # -- calibration artifact loader ---------------------------------------
    @classmethod
    def from_calibration(
        cls,
        source: Union[str, "os.PathLike[str]", Mapping],
        parallel_efficiency: Optional[float] = None,
    ) -> "PerfModel":
        """Build a measured PerfModel from the kernel profiler's artifact.

        ``source`` is a ``CALIBRATION.json`` path or the already-parsed
        report dict (the reference profiler's ``run_calibration`` output).  Each
        device's ``whole_device`` rates become the calibration table entry
        and the profiler's fitted ``parallel_efficiency`` (mean across
        devices, clamped to (0, 1]) becomes the scaling exponent unless
        overridden.
        """
        if isinstance(source, Mapping):
            rep = source
        else:
            with open(source) as f:
                rep = json.load(f)
        schema = str(rep.get("schema", "calibration/v1"))
        if not schema.startswith("calibration/"):
            raise ValueError(f"not a calibration artifact (schema={schema!r})")
        devices = rep.get("devices") or {}
        if not devices:
            raise ValueError("calibration artifact has no devices section")
        table: Dict[str, DeviceThroughput] = {}
        effs = []
        for name, entry in devices.items():
            whole = entry.get("whole_device") or {}
            prefill = float(whole.get("prefill_tokens_per_s", 0.0))
            decode = float(whole.get("decode_tokens_per_s", 0.0))
            if prefill <= 0.0 or decode <= 0.0:
                raise ValueError(
                    f"device {name!r}: non-positive whole-device rates "
                    f"({prefill}, {decode})"
                )
            table[name] = DeviceThroughput(prefill, decode)
            e = entry.get("parallel_efficiency")
            if isinstance(e, (int, float)):
                effs.append(float(e))
        if parallel_efficiency is None:
            parallel_efficiency = sum(effs) / len(effs) if effs else 1.0
            parallel_efficiency = min(max(parallel_efficiency, 1e-3), 1.0)
        return cls(calibration=table, parallel_efficiency=parallel_efficiency)

    # -- per-profile --------------------------------------------------------
    def rates(self, device: DeviceModel, profile_id: int) -> Tuple[float, float]:
        """(prefill tokens/s, decode tokens/s) of ``profile_id`` on ``device``."""
        prof = device.profile(profile_id)
        base = self.device_throughput(device)
        e = self.parallel_efficiency
        cfrac = (prof.compute_slices / device.n_gpu_slices) ** e
        mfrac = (prof.memory_slices / device.n_memory_slices) ** e
        return (
            base.prefill_tokens_per_s * cfrac,
            base.decode_tokens_per_s * mfrac,
        )

    def service_seconds(
        self, device: DeviceModel, profile_id: int, prompt_len: int, decode_len: int
    ) -> Tuple[float, float]:
        """(prefill seconds, decode seconds) for one request on the profile."""
        prefill_tps, decode_tps = self.rates(device, profile_id)
        return prompt_len / prefill_tps, decode_len / decode_tps

    def tpot_seconds(self, device: DeviceModel, profile_id: int) -> float:
        """Steady-state time-per-output-token of the profile."""
        _, decode_tps = self.rates(device, profile_id)
        return 1.0 / decode_tps

    def capacity_rps(
        self,
        device: DeviceModel,
        profile_id: int,
        mean_prompt_len: int,
        mean_decode_len: int,
    ) -> float:
        """Sustainable requests/s of ONE replica on the profile, at the
        model's mean request shape (the autoscaler's denominator)."""
        prefill_s, decode_s = self.service_seconds(
            device, profile_id, mean_prompt_len, mean_decode_len
        )
        return 1.0 / max(prefill_s + decode_s, 1e-12)
