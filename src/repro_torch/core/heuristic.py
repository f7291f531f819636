"""Rule-based / heuristic placement model (paper Sec 4.2).

Solves the three use cases separately, avoiding sequential migration by
construction:

* ``initial_deployment``  — size-sorted max-utilization placement.
* ``compaction``          — vacate least-utilized GPUs into other allocated
                            GPUs; if blocked, use one free GPU provided it
                            saves more than one GPU net (paper Fig. 8).
* ``reconfiguration``     — lower-bound GPU count (Eq. 3), extra-memory
                            profiles first, then first-fit decreasing with
                            feasibility checks and preference-order indexes.

All functions mutate the given ClusterState in place and return the list of
pending (unplaceable) workloads.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from .baselines import place_max_utilization
from .state import ClusterState, GPUState, Workload

__all__ = ["initial_deployment", "compaction", "reconfiguration"]


# ---------------------------------------------------------------------------
# Initial deployment (Sec 4.2, Steps 1-3)
# ---------------------------------------------------------------------------
def initial_deployment(
    state: ClusterState, new_workloads: Sequence[Workload]
) -> List[Workload]:
    device = next(iter(state.gpus.values())).device
    pending: List[Workload] = []
    # Step 1: sort new workloads in descending size (profile id is the proxy).
    ordered = sorted(
        new_workloads, key=lambda w: (device.profile(w.profile_id).sort_key, w.wid)
    )
    for w in ordered:
        state.add_workload(w)
        # Steps 2-3: GPU with max utilization after assignment, preference
        # order for the index; allocate a new GPU when nothing fits.
        spot = place_max_utilization(state, w)
        if spot is None:
            pending.append(w)
        else:
            state.place(w.wid, *spot)
    return pending


# ---------------------------------------------------------------------------
# Compaction (Sec 4.2)
# ---------------------------------------------------------------------------
def _vacate(state: ClusterState, gid: str, targets: Sequence[str]) -> bool:
    """Try to empty ``gid`` into ``targets`` with one-shot migrations only.

    Runs inside a transaction on the real state: the moves are committed on
    success and rolled back (O(#ops), no clone) on failure.  "One-shot" means
    every destination span must already be free *before this vacate started*
    (no dependency on other moves off-GPU).
    """
    targets = [t for t in targets if t != gid]
    # Pre-move snapshots of the destinations, for the one-shot verification.
    before = {t: state.gpus[t].clone() for t in targets}
    with state.transaction() as txn:
        moves: List[Tuple[str, str, int]] = []
        victims = sorted(
            state.gpus[gid].placements,
            key=lambda p: state.gpus[gid].device.profile(p.profile_id).sort_key,
        )
        for pl in list(victims):
            w = state.workloads[pl.wid]
            state.remove(pl.wid, gid)
            spot = place_max_utilization(
                state, w, candidates=targets, allow_new_gpu=False
            )
            if spot is None:
                txn.rollback()
                return False
            state.place(w.wid, *spot)
            moves.append((w.wid, spot[0], spot[1]))
        for wid, dst, idx in moves:
            prof = state.gpus[dst].device.profile(state.workloads[wid].profile_id)
            if not before[dst].can_place_at(prof, idx):
                txn.rollback()
                return False
    return True


def compaction(state: ClusterState) -> List[Workload]:
    """Vacate underutilized GPUs (paper Sec 4.2 compaction steps 1-3)."""
    progress = True
    while progress:
        progress = False
        # Step 1: sort allocated GPUs by joint slice utilization ascending.
        used = sorted(
            state.used_gpus(), key=lambda g: (g.joint_slice_utilization(), g.gid)
        )
        for gpu in used:
            others = [g.gid for g in state.used_gpus() if g.gid != gpu.gid]
            # Step 3 feasibility pre-check: enough free slices elsewhere?
            need = sum(
                gpu.device.profile(p.profile_id).memory_slices
                for p in gpu.placements
            )
            have = sum(len(state.gpus[o].free_gpu_slices()) for o in others) + sum(
                1
                for o in others
                if state.gpus[o].memory_occupancy()[-1] is None
            )
            if have < need:
                continue
            if _vacate(state, gpu.gid, others):
                progress = True
                break
        if progress:
            continue
        # Fallback (paper Fig. 8): borrow ONE free GPU if that lets us vacate
        # more than one allocated GPU (net saving >= 1).
        free = sorted(state.free_gpus(), key=lambda g: g.gid)
        if not free:
            continue
        borrowed = free[0].gid
        with state.transaction() as outer:
            vacated = 0
            used = sorted(
                state.used_gpus(), key=lambda g: (g.joint_slice_utilization(), g.gid)
            )
            for gpu in used:
                targets = [
                    g.gid for g in state.used_gpus() if g.gid != gpu.gid
                ] + [borrowed]
                if _vacate(state, gpu.gid, targets):
                    vacated += 1
            if vacated > 1:
                progress = True
            else:
                outer.rollback()
    return []


# ---------------------------------------------------------------------------
# Reconfiguration / redeployment (Sec 4.2)
# ---------------------------------------------------------------------------
def min_gpus_needed(device, workloads: Sequence[Workload]) -> int:
    """Equation 3 lower bound."""
    c = sum(device.profile(w.profile_id).compute_slices for w in workloads)
    m = sum(device.profile(w.profile_id).memory_slices for w in workloads)
    return max(
        math.ceil(c / device.n_gpu_slices), math.ceil(m / device.n_memory_slices)
    )


def reconfiguration(state: ClusterState) -> List[Workload]:
    """Re-place ALL existing workloads optimally (paper Sec 4.2 steps 1-5)."""
    device = next(iter(state.gpus.values())).device
    workloads = state.placed_workloads()
    if not workloads:
        return []
    n_min = min_gpus_needed(device, workloads)

    # Step 2 ordering: least utilized first => free GPUs first.
    by_util = sorted(
        state.gpus.values(), key=lambda g: (g.joint_slice_utilization(), g.gid)
    )
    all_gids = [g.gid for g in by_util]

    for n in range(n_min, len(all_gids) + 1):
        targets = all_gids[:n]
        fresh = ClusterState(
            gpus={gid: GPUState(gid, device) for gid in targets},
            workloads={w.wid: w for w in workloads},
        )
        pending = _reconfigure_into(fresh, device, workloads)
        if not pending:
            # Commit: adopt the fresh layout (journaled diff-apply — GPUs
            # outside ``targets`` are emptied by the removals it derives).
            state.adopt(fresh)
            return []
    # Could not place everything even with all GPUs (shouldn't happen when
    # the initial state was feasible): keep initial layout.
    return []


def _reconfigure_into(
    fresh: ClusterState, device, workloads: Sequence[Workload]
) -> List[Workload]:
    gids = sorted(fresh.gpus.keys())
    remaining = list(workloads)

    # Step 3: extra-memory profiles first (profile 9, then 15), one per GPU,
    # at the index that captures m7.
    for pid, idx in ((9, 4), (15, 6)):
        for gid in gids:
            if fresh.gpus[gid].memory_occupancy()[-1] is not None:
                continue
            cand = next((w for w in remaining if w.profile_id == pid), None)
            if cand is None:
                break
            prof = device.profile(pid)
            if fresh.gpus[gid].can_place_at(prof, idx):
                fresh.gpus[gid].place(cand.wid, pid, idx)
                remaining.remove(cand)

    # Step 4: sort remaining by profile id (descending size).
    remaining.sort(key=lambda w: (device.profile(w.profile_id).sort_key, w.wid))

    # Step 5: first-fit decreasing with preference-order indexes.
    pending: List[Workload] = []
    for w in remaining:
        prof = device.profile(w.profile_id)
        for gid in gids:
            idx = fresh.gpus[gid].first_feasible_index(prof)
            if idx is not None:
                fresh.gpus[gid].place(w.wid, w.profile_id, idx)
                break
        else:
            pending.append(w)
    return pending
