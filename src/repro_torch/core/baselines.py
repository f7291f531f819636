"""Baseline schedulers from the paper's evaluation (Sec 5.1, 'Approaches').

* ``first_fit``      — sort GPUs and workloads by ID; place each workload at
                       the first feasible (GPU, index), indexes tried in
                       increasing numeric order starting at 0.
* ``load_balanced``  — resource-based dynamic load balancing: GPUs sorted by
                       joint slice utilization ascending (re-sorted after
                       every placement); workloads in arrival order; indexes
                       tried in increasing numeric order starting at 0.

Both mutate the given state and return the list of pending workloads.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .state import ClusterState, GPUState, Workload

__all__ = ["first_fit", "load_balanced", "place_max_utilization"]


def _numeric_index_order(profile) -> List[int]:
    return sorted(profile.allowed_indexes)


def _try_place(
    gpu: GPUState, w: Workload, numeric_order: bool
) -> Optional[int]:
    prof = gpu.device.profile(w.profile_id)
    order = _numeric_index_order(prof) if numeric_order else prof.allowed_indexes
    return gpu.first_feasible_index(prof, order)


def first_fit(
    state: ClusterState, workloads: Sequence[Workload]
) -> List[Workload]:
    """First-fit by IDs; returns pending workloads."""
    pending: List[Workload] = []
    gids = state.ordered_gids()
    for w in sorted(workloads, key=lambda w: w.wid):
        state.add_workload(w)
        placed = False
        for gid in gids:
            idx = _try_place(state.gpus[gid], w, numeric_order=True)
            if idx is not None:
                state.place(w.wid, gid, idx)
                placed = True
                break
        if not placed:
            pending.append(w)
    return pending


def load_balanced(
    state: ClusterState, workloads: Sequence[Workload]
) -> List[Workload]:
    """Resource-based dynamic load balancing; returns pending workloads."""
    pending: List[Workload] = []
    for w in workloads:  # arrival order
        state.add_workload(w)
        ordered = sorted(
            state.gpus.values(),
            key=lambda g: (g.joint_slice_utilization(), g.gid),
        )
        placed = False
        for gpu in ordered:
            idx = _try_place(gpu, w, numeric_order=True)
            if idx is not None:
                state.place(w.wid, gpu.gid, idx)
                placed = True
                break
        if not placed:
            pending.append(w)
    return pending


def place_max_utilization(
    state: ClusterState,
    w: Workload,
    candidates: Optional[Sequence[str]] = None,
    allow_new_gpu: bool = True,
) -> Optional[Tuple[str, int]]:
    """Rule-based placement primitive (Sec 4.2, initial deployment Step 3).

    Choose the GPU whose joint slice utilization is maximal *after* the
    assignment (ties broken towards lower waste index via the Table-1
    preference order); falls back to allocating a free GPU.
    Returns (gid, index) without mutating state, or None.
    """
    prof = state.gpus[next(iter(state.gpus))].device.profile(w.profile_id)
    pool = candidates if candidates is not None else state.ordered_gids()
    best: Optional[Tuple[float, str, int]] = None
    for gid in pool:
        gpu = state.gpus[gid]
        if gpu.is_empty() and candidates is None:
            continue  # used GPUs first; free GPUs are the fallback
        idx = gpu.first_feasible_index(prof)
        if idx is None:
            continue
        util = gpu.joint_slice_utilization()
        if best is None or util > best[0] or (util == best[0] and gid < best[1]):
            best = (util, gid, idx)
    if best is not None:
        return best[1], best[2]
    if allow_new_gpu and candidates is None:
        for gpu in sorted(state.free_gpus(), key=lambda g: g.gid):
            idx = gpu.first_feasible_index(prof)
            if idx is not None:
                return gpu.gid, idx
    return None
