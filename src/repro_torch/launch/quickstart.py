"""Quickstart: the paper's contribution in one page.  Twin of the
reference's ``examples/quickstart.py`` on the port's placement core.

Builds an 8-GPU A100 cluster in the Sec-5.1 simulator, then places the same
random workload set with all four approaches (first-fit, load-balanced,
rule-based heuristic, WPM MIP) and prints the Table-3 metrics side by side.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--verbose]

Placement only: it touches no tensor, so it takes no device.  Output goes
through the std `logging` module (stderr); `--verbose` adds debug-level
detail.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from repro_torch.core import baselines, heuristic, metrics
from repro_torch.core.simulator import generate_test_case
from repro_torch.core.wpm_mip import solve_wpm

log = logging.getLogger("repro_torch.launch.quickstart")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(message)s",
    )

    tc = generate_test_case(seed=7, n_gpus=8)
    n_new = len(tc.new_workloads)
    n_old = len(tc.initial.workloads)
    log.info(f"cluster: 8 x A100-80GB | existing workloads: {n_old} | new: {n_new}\n")

    rows = []
    for name in ("first_fit", "load_balanced", "rule_based", "mip", "joint_mip"):
        st = tc.initial.clone()
        if name == "first_fit":
            baselines.first_fit(st, tc.new_workloads)
        elif name == "load_balanced":
            baselines.load_balanced(st, tc.new_workloads)
        elif name == "rule_based":
            heuristic.initial_deployment(st, tc.new_workloads)
        else:
            res = solve_wpm(
                st, tc.new_workloads,
                movable=(name == "joint_mip"),
                allow_reconfig=(name == "joint_mip"),
                time_limit=10.0,
            )
            st = res.state
        st.validate()
        m = metrics.evaluate(
            st, tc.initial, list(tc.initial.workloads.values()) + tc.new_workloads
        )
        rows.append((name, m))

    hdr = (f"{'approach':14} {'#GPUs':>5} {'pend':>5} {'cWaste':>6} {'mWaste':>6} "
           f"{'avail':>6} {'cUtil':>6} {'mUtil':>6} {'seqMig':>6}")
    log.info(hdr)
    log.info("-" * len(hdr))
    for name, m in rows:
        log.info(f"{name:14} {m.n_gpus:5d} {m.n_pending:5d} {m.compute_wastage:6d} "
                 f"{m.memory_wastage:6d} {m.availability:6d} "
                 f"{m.compute_utilization:6.2f} {m.memory_utilization:6.2f} "
                 f"{m.sequential_migrations:6d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
