"""Beyond-paper: pattern-enumeration exact placement (Gilmore–Gomory style).

The WPM MIP's variable count grows as O(|W| x |G|), which is why the paper
caps CPLEX at 30 s for 80-GPU clusters.  But the *content* of one GPU is one
of a small finite set of index-feasible profile multisets ("patterns" —
a few hundred for the A100 geometry).  Reconfiguration (and any placement
onto empty devices) therefore reduces to an integer program over pattern
counts whose size is INDEPENDENT of cluster size:

    min   sum_P n_P * (q + gamma_W * waste(P))
    s.t.  sum_P n_P * count_P(profile) = demand(profile)   for each profile
          n_P >= 0 integer

With ~6 coverage rows and a few hundred columns this solves in milliseconds
for clusters of any size (we demonstrate 10k+ GPUs in the solver-scaling
benchmark), and the solution is provably optimal for the (#GPUs, wastage)
objective.  Waste per pattern is precomputed once via the exact indexing
step, so the reported wastage is index-accurate, not the bin-level proxy.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .indexing import assign_indexes, enumerate_feasible_multisets
from .profiles import A100_80GB, DeviceModel
from .state import ClusterState, GPUState, Workload

__all__ = ["Pattern", "pattern_catalog", "reconfigure_patterns", "PatternResult"]


@dataclasses.dataclass(frozen=True)
class Pattern:
    counts: Tuple[Tuple[int, int], ...]  # sorted (profile_id, n)
    compute_waste: int
    memory_waste: int
    layout: Tuple[Tuple[int, int], ...]  # (profile_id, index) optimal indexing

    @property
    def size(self) -> int:
        return sum(n for _, n in self.counts)


@functools.lru_cache(maxsize=8)
def pattern_catalog(device: DeviceModel = A100_80GB) -> Tuple[Pattern, ...]:
    """All index-feasible patterns with their optimal-waste concrete layouts."""
    out: List[Pattern] = []
    for counts in enumerate_feasible_multisets(device):
        flat: List[int] = []
        for pid, n in sorted(counts.items()):
            flat.extend([pid] * n)
        gpu = GPUState("_pat", device)
        placements = assign_indexes(gpu, flat, optimize=True)
        assert placements is not None  # feasible by construction
        gpu.placements.extend(placements)
        out.append(
            Pattern(
                counts=tuple(sorted(counts.items())),
                compute_waste=gpu.compute_waste(),
                memory_waste=gpu.memory_waste(),
                layout=tuple((p.profile_id, p.index) for p in placements),
            )
        )
    return tuple(out)


@dataclasses.dataclass
class PatternResult:
    state: ClusterState
    n_gpus: int
    objective: float
    solve_seconds: float
    status: str


def reconfigure_patterns(
    state: ClusterState,
    extra_workloads: Sequence[Workload] = (),
    gpu_cost: float = 100.0,
    wastage_cost: float = 10.0,
    time_limit: float = 30.0,
) -> PatternResult:
    """Optimal reconfiguration: re-place ALL workloads (plus extras) from scratch.

    Requires enough total GPUs; raises otherwise.  Solution is exact for the
    (#GPUs, total index-level wastage) objective.
    """
    t0 = time.time()
    device = next(iter(state.gpus.values())).device
    workloads = list(state.placed_workloads()) + list(extra_workloads)
    demand: Dict[int, int] = {}
    for w in workloads:
        demand[w.profile_id] = demand.get(w.profile_id, 0) + 1

    cat = [
        p
        for p in pattern_catalog(device)
        if all(pid in demand for pid, _ in p.counts)
    ]
    pids = sorted(demand)
    A = np.zeros((len(pids), len(cat)))
    for j, pat in enumerate(cat):
        for pid, n in pat.counts:
            A[pids.index(pid), j] = n
    cost = np.array(
        [gpu_cost + wastage_cost * (p.compute_waste + p.memory_waste) for p in cat]
    )
    b = np.array([demand[p] for p in pids], dtype=float)

    from scipy.optimize import Bounds, LinearConstraint, milp

    n_max = len(state.gpus)
    res = milp(
        c=cost,
        constraints=[LinearConstraint(A, b, b)],
        integrality=np.ones(len(cat), dtype=np.int64),
        bounds=Bounds(np.zeros(len(cat)), np.full(len(cat), float(n_max))),
        options={"time_limit": time_limit},
    )
    if res.x is None:
        raise RuntimeError(f"pattern ILP infeasible: {res.message}")
    counts = np.round(res.x).astype(int)
    n_used = int(counts.sum())
    if n_used > len(state.gpus):
        raise RuntimeError(f"needs {n_used} GPUs, cluster has {len(state.gpus)}")

    # Materialize: assign concrete workloads to pattern slots, preferring to
    # keep workloads on their current GPU when the pattern matches (reduces
    # migration size at no objective cost).
    final = ClusterState(
        gpus={gid: GPUState(gid, state.gpus[gid].device) for gid in state.gpus},
        workloads={w.wid: w for w in workloads},
    )
    pool: Dict[int, List[Workload]] = {}
    for w in workloads:
        pool.setdefault(w.profile_id, []).append(w)
    # Fill free GPUs first (one-shot migration, paper Sec 2.3.3).
    order = [g.gid for g in state.free_gpus()] + [g.gid for g in state.used_gpus()]
    gi = 0
    for j, n in enumerate(counts):
        for _ in range(int(n)):
            gid = order[gi]
            gi += 1
            for pid, idx in cat[j].layout:
                w = pool[pid].pop()
                final.gpus[gid].place(w.wid, pid, idx)
    final.validate()
    return PatternResult(
        state=final,
        n_gpus=n_used,
        objective=float(cost @ counts),
        solve_seconds=time.time() - t0,
        status="optimal" if res.status == 0 else "time_limit",
    )
