"""Cluster simulation and random test-case generation (paper Sec 5.1).
Copy of ``repro/core/simulator.py``; the default device stays the
A100 80GB, so a seed gives the reference's case.  Callers that place on the
card the port serves on pass ``device=H100_80GB``.

A test case mimics a cluster with one or more 8-GPU nodes:
  * ~60% of GPUs allocated, the rest free;
  * each allocated GPU gets a random target utilization (up to 100%) and is
    filled with randomly drawn profile workloads placed at preference-order
    indexes until the target is met;
  * for the initial-deployment use case, new workloads totalling ~60% of the
    whole cluster's memory-slice capacity are generated.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .fleetgen import build_fleet
from .profiles import A100_80GB, DeviceModel
from .state import ClusterState, Workload

__all__ = ["TestCase", "generate_test_case", "random_workloads"]

#: profiles drawn for random workloads (paper Table 1, excl. the full-GPU
#: profile 0 — a 7g.80gb replica trivially owns a GPU and adds no packing
#: signal — and the rare +me profile 20 by default).
_DEFAULT_PROFILE_POOL = (5, 9, 14, 15, 19)


@dataclasses.dataclass
class TestCase:
    name: str
    initial: ClusterState
    new_workloads: List[Workload]


def random_workloads(
    rng: np.random.Generator,
    total_memory_slices: int,
    device: DeviceModel = A100_80GB,
    prefix: str = "new",
    pool: Sequence[int] = _DEFAULT_PROFILE_POOL,
) -> List[Workload]:
    """Random profile workloads summing to ~total_memory_slices memory."""
    out: List[Workload] = []
    used = 0
    i = 0
    while used < total_memory_slices:
        pid = int(rng.choice(pool))
        prof = device.profile(pid)
        if used + prof.memory_slices > total_memory_slices:
            # close the gap with the smallest profile
            pid = pool[-1]
            prof = device.profile(pid)
            if used + prof.memory_slices > total_memory_slices:
                break
        out.append(Workload(wid=f"{prefix}{i}", profile_id=pid))
        used += prof.memory_slices
        i += 1
    return out


def generate_test_case(
    seed: int,
    n_gpus: int = 8,
    device: DeviceModel = A100_80GB,
    allocated_fraction: float = 0.6,
    new_workload_fraction: float = 0.6,
    pool: Sequence[int] = _DEFAULT_PROFILE_POOL,
) -> TestCase:
    """One Sec-5.1 test case (seeded, reproducible)."""
    rng = np.random.default_rng(seed)
    # Shared fleet builder (fleetgen) with the historical 'gpu{i}' naming.
    state = build_fleet([(device, n_gpus)], gid_format="gpu{i}")
    gids = state.ordered_gids()
    n_alloc = int(round(n_gpus * allocated_fraction))
    alloc_gids = list(rng.choice(gids, size=n_alloc, replace=False))

    wi = 0
    for gid in alloc_gids:
        gpu = state.gpus[gid]
        target = rng.uniform(0.2, 1.0)  # random utilization up to 100%
        # fill with random workloads until target joint utilization reached
        attempts = 0
        while gpu.joint_slice_utilization() < target and attempts < 20:
            pid = int(rng.choice(pool))
            prof = device.profile(pid)
            idx = gpu.first_feasible_index(prof)
            if idx is None:
                attempts += 1
                continue
            w = Workload(wid=f"w{wi}", profile_id=pid)
            state.add_workload(w)
            gpu.place(w.wid, pid, idx)
            wi += 1
    # New workloads ~ fraction of total cluster memory capacity.
    total_mem = n_gpus * device.n_memory_slices
    news = random_workloads(
        rng, int(total_mem * new_workload_fraction), device, pool=pool
    )
    return TestCase(name=f"case{seed}-{n_gpus}gpu", initial=state, new_workloads=news)
