"""Paper Figures 4 & 5 walked through on the migration control plane: a
fragmented 3-GPU node is compacted (one GPU vacated), then reconfigured
(wastage eliminated as well) — each verb returning a *scored* MigrationPlan
(bytes to transfer, downtime, migration-window makespans) and a commit
decision, instead of mutating blindly.  Twin of the reference's
``examples/compaction_demo.py`` on the port's placement core.

    PYTHONPATH=src python -m repro_torch.launch.compaction_demo [--verbose]

Placement only: rule_based on three GPUs never sweeps the fleet (the fabric
starts at 128 GPUs), so it touches no tensor and takes no device; its
engines ask for the numpy sweep (``fabric_device=None``).  Output goes
through the std `logging` module (stderr); `--verbose` adds debug-level
detail (per-GPU occupancy maps).
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from repro_torch.core import metrics
from repro_torch.core.engine import CommitPolicy, PlacementEngine
from repro_torch.core.state import ClusterState, Workload

log = logging.getLogger("repro_torch.launch.compaction_demo")


def draw(state: ClusterState) -> None:
    for gid in state.ordered_gids():
        gpu = state.gpus[gid]
        occ = gpu.memory_occupancy()
        cells = "".join(f"[{(w or '--'):>4}]" for w in occ)
        waste = gpu.compute_waste() + gpu.memory_waste()
        log.debug(f"  {gid}: {cells}  waste={waste}")


def report(tag: str, state: ClusterState, initial=None) -> None:
    m = metrics.evaluate(state, initial)
    log.info(f"{tag}: GPUs={m.n_gpus} computeWaste={m.compute_wastage} "
             f"memWaste={m.memory_wastage} cUtil={m.compute_utilization:.0%} "
             f"mUtil={m.memory_utilization:.0%}")
    draw(state)


def describe_plan(tag: str, res) -> None:
    plan, cost = res.plan, res.cost
    log.info(f"\n{tag} plan: {plan.n_moves} moves ({plan.n_sequential} sequential, "
             f"{len(plan.disruptive)} disruptive), waves={[len(w) for w in plan.waves]}")
    log.info(f"  cost: {cost.total_bytes / 2**30:.0f} GiB to move, "
             f"downtime {cost.downtime_seconds:.1f}s, "
             f"window {cost.duration_seconds:.1f}s "
             f"(makespans {[round(s, 2) for s in cost.wave_makespans]})")
    log.info(f"  gains: {res.gains.gpus_saved} GPU(s) saved, "
             f"{res.gains.waste_saved} wastage slice(s) removed")
    log.info(f"  decision [{res.decision.reason}] -> "
             f"{'COMMIT' if res.committed else 'REJECT'}")


def build_fig4_state() -> ClusterState:
    """Fragmented initial state in the spirit of paper Fig. 4: three GPUs,
    13/21 compute and 15/24 memory slices used, two compute-wasting
    placements (3g.40gb at index 0)."""
    st = ClusterState.homogeneous(3)
    wl = [
        ("w1", 5, "gpu0", 0),   # 4g.40gb @ 0
        ("w2", 9, "gpu1", 0),   # 3g.40gb @ 0  <- wastes a compute slice
        ("w3", 14, "gpu1", 4),  # 2g.20gb @ 4
        ("w4", 19, "gpu1", 6),  # 1g.10gb @ 6  <- strands m7
        ("w5", 19, "gpu2", 0),  # 1g.10gb
        ("w6", 19, "gpu2", 1),  # 1g.10gb
        ("w7", 15, "gpu2", 4),  # 1g.20gb @ 4  <- wastes a compute slice
    ]
    for wid, pid, gid, idx in wl:
        st.add_workload(Workload(wid=wid, profile_id=pid))
        st.place(wid, gid, idx)
    return st


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(message)s",
    )

    initial = build_fig4_state()
    report("initial   ", initial)
    engine = PlacementEngine("rule_based", fabric_device=None)

    # --- compaction (Fig. 4): vacate underutilized GPUs, one-shot moves only
    compacted = initial.clone()
    res_c = engine.compact(compacted)
    describe_plan("compaction", res_c)
    report("compacted ", compacted, initial)

    # --- reconfiguration (Fig. 5): re-place everything, kill the wastage too
    reconfigured = initial.clone()
    res_r = engine.reconfigure(reconfigured)
    describe_plan("reconfiguration", res_r)
    report("reconfig  ", reconfigured, initial)

    # --- the control plane at work: a net-positive engine rejects a repack
    # whose disruption outweighs its gains (state stays byte-identical).
    frugal = PlacementEngine(
        "rule_based",
        fabric_device=None,
        commit=CommitPolicy(mode="net-positive", gpu_seconds_value=0.5,
                            waste_seconds_value=0.1),
    )
    guarded = initial.clone()
    res_g = frugal.reconfigure(guarded)
    describe_plan("guarded reconfiguration", res_g)

    mc = metrics.evaluate(compacted, initial)
    mr = metrics.evaluate(reconfigured, initial)
    assert res_c.committed and res_r.committed
    assert mc.n_gpus <= 2, "compaction should vacate a GPU"
    assert mr.compute_wastage <= mc.compute_wastage
    assert not res_g.committed, "undervalued gains must be rejected"
    assert metrics.evaluate(guarded).n_gpus == metrics.evaluate(initial).n_gpus
    log.info("\nOK: compaction saved a GPU; reconfiguration also removed wastage; "
             "the net-positive policy rejected the undervalued repack")
    return 0


if __name__ == "__main__":
    sys.exit(main())
