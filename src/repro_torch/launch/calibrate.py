"""Calibration CLI: profile the kernels, write ``CALIBRATION.json``.
Counterpart of the reference's ``benchmarks/calibrate.py``.

Runs the kernel calibration profiler (:mod:`repro_torch.obs.profile`) over
the requested device models and problem-size preset, then writes the
schema-validated artifact that closes the measure -> model -> plan loop:

    PYTHONPATH=src python -m repro_torch.launch.calibrate --preset full
    PYTHONPATH=src python -m repro_torch.launch.calibrate --torch-device cpu \\
        --preset tiny --out /tmp/cal.json                  # plain versions

Load it back with ``PerfModel.from_calibration("CALIBRATION.json")``, or
hand that model to ``ClusterServer(perf=...)``.

``--device`` names device models (the MIG ladders to sweep), as in the
reference; the torch device the ops run on is ``--torch-device`` (default
``cuda``: the hand-written kernels; ``cpu``: their plain versions).  This
is not ``launch/serve.py``'s ``--device``, which is a torch device there.

``--telemetry`` additionally dumps the per-rep ``kernel_wall_seconds``
histograms (Prometheus text) recorded during the sweep.  The report always
carries a host-contention snapshot (``host.contended``) — treat timings
from a contended run as suspect (the CLI warns loudly).
"""
from __future__ import annotations

import argparse
import logging
import sys

from repro_torch import obs
from repro_torch.core.profiles import A100_80GB, H100_80GB, H100_96GB
from repro_torch.core.tpu_profiles import TPU_V5E_POD
from repro_torch.obs import profile

log = logging.getLogger("repro_torch.launch.calibrate")

DEVICES = {d.name: d for d in (A100_80GB, H100_96GB, H100_80GB, TPU_V5E_POD)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", nargs="+", default=[H100_80GB.name],
                    choices=sorted(DEVICES), help="device models to calibrate")
    ap.add_argument("--preset", default="small",
                    choices=sorted(profile.PRESETS),
                    help="problem-size preset (tiny = CI smoke)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps per measurement (default: preset's)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="discarded warm-up calls (default: preset's)")
    ap.add_argument("--torch-device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ops run: cuda = the hand-written kernels, "
                    "cpu = their plain versions")
    ap.add_argument("--no-emulate", action="store_true",
                    help="do NOT apply slice fractions analytically — use "
                    "when running inside a real MIG GPU instance")
    ap.add_argument("--out", default="CALIBRATION.json",
                    help="artifact path ('' = stdout summary only)")
    ap.add_argument("--telemetry", action="store_true",
                    help="dump kernel_wall_seconds histograms "
                    "(Prometheus text) next to the artifact")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(message)s",
    )

    tel = obs.enable() if args.telemetry else None
    try:
        report = profile.run_calibration(
            devices=[DEVICES[n] for n in args.device],
            preset=args.preset,
            reps=args.reps,
            warmup=args.warmup,
            emulate=not args.no_emulate,
            device=args.torch_device,
        )
    finally:
        if tel is not None:
            obs.disable()

    for name, entry in report["devices"].items():
        whole = entry["whole_device"]
        log.info(
            "%-20s prefill %10.0f tok/s   decode %8.0f tok/s   "
            "fitted parallel_efficiency %.3f",
            name, whole["prefill_tokens_per_s"], whole["decode_tokens_per_s"],
            entry["parallel_efficiency"],
        )
        for pid, prof in entry["profiles"].items():
            log.info("  %-12s (id %2s)  prefill %10.0f  decode %8.0f",
                     prof["name"], pid, prof["prefill_tokens_per_s"],
                     prof["decode_tokens_per_s"])
    if report["host"]["contended"]:
        log.warning("host was contended during the sweep — artifact carries "
                    "contended=true; re-run on a quiet machine before "
                    "committing these numbers")

    if obs.write_report(args.out, report, profile.CALIBRATION_SCHEMA):
        log.info("wrote %s", args.out)
        log.info("load with: PerfModel.from_calibration(%r)", args.out)
    if tel is not None:
        prom = (args.out or "CALIBRATION") + ".prom"
        with open(prom, "w") as f:
            f.write(obs.prometheus_text(tel.metrics))
        log.info("wrote %s", prom)
    return 0


if __name__ == "__main__":
    sys.exit(main())
