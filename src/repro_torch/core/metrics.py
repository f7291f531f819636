"""Table-3 evaluation metrics.

All metrics are computed on a *final* ClusterState against the *initial*
ClusterState (for migration-related metrics) and the workload set (for
pending-related metrics).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .state import ClusterState, Workload

__all__ = ["PlacementMetrics", "evaluate"]


@dataclasses.dataclass
class PlacementMetrics:
    n_gpus: int
    memory_wastage: int
    compute_wastage: int
    availability: int
    migration_size: int
    pending_model_size: int
    sequential_migrations: int
    memory_utilization: float
    compute_utilization: float
    n_pending: int
    n_migrations: int
    #: mean free-slice fragmentation over used GPUs (Ting et al.): 0 = every
    #: GPU's free space is one contiguous run, ->1 = shattered free space.
    fragmentation: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def evaluate(
    final: ClusterState,
    initial: Optional[ClusterState] = None,
    all_workloads: Optional[Sequence[Workload]] = None,
) -> PlacementMetrics:
    """Compute every Table-3 metric for a final placement solution."""
    final.validate()
    used = final.used_gpus()
    n_gpus = len(used)

    memory_wastage = sum(g.memory_waste() for g in used)
    compute_wastage = sum(g.compute_waste() for g in used)

    # Pending workloads: requested but not placed anywhere.
    placed_wids = {p.wid for g in final.gpus.values() for p in g.placements}
    pending: List[Workload] = []
    if all_workloads is not None:
        pending = [w for w in all_workloads if w.wid not in placed_wids]
    pending_size = sum(
        w.profile(final.gpus[next(iter(final.gpus))].device).memory_slices
        for w in pending
    ) if final.gpus else 0

    # Availability: free GPU slices cluster-wide minus total pending size.
    free_slices = sum(len(g.free_gpu_slices()) for g in final.gpus.values())
    availability = free_slices - pending_size

    # Migration metrics need the initial state.
    migration_size = 0
    sequential = 0
    n_migrations = 0
    if initial is not None:
        for wid in placed_wids:
            src = initial.placement_of(wid)
            dst = final.placement_of(wid)
            if src is None or dst is None:
                continue
            (src_gid, src_pl), (dst_gid, dst_pl) = src, dst
            if src_gid == dst_gid and src_pl.index == dst_pl.index:
                continue
            n_migrations += 1
            if src_gid != dst_gid:
                device = final.gpus[dst_gid].device
                migration_size += device.profile(dst_pl.profile_id).memory_slices
                # Sequential migration: the target (index, profile) span was
                # not free in the *initial* state of the destination GPU.
                prof = device.profile(dst_pl.profile_id)
                if not initial.gpus[dst_gid].can_place_at(prof, dst_pl.index):
                    sequential += 1

    # Utilizations over *used* GPUs only (Table 3).
    tot_mem = sum(g.device.n_memory_slices for g in used)
    tot_cmp = sum(g.device.n_gpu_slices for g in used)
    used_mem = sum(g.used_memory_slices() for g in used)
    used_cmp = sum(g.used_compute_slices() for g in used)

    return PlacementMetrics(
        n_gpus=n_gpus,
        memory_wastage=memory_wastage,
        compute_wastage=compute_wastage,
        availability=availability,
        migration_size=migration_size,
        pending_model_size=pending_size,
        sequential_migrations=sequential,
        memory_utilization=used_mem / tot_mem if tot_mem else 0.0,
        compute_utilization=used_cmp / tot_cmp if tot_cmp else 0.0,
        n_pending=len(pending),
        n_migrations=n_migrations,
        fragmentation=(
            sum(g.fragmentation() for g in used) / len(used) if used else 0.0
        ),
    )
