"""Algorithm 1: preprocessing partially-partitioned GPUs into free partitions.

For every GPU ``g`` with immovable pre-existing workloads, compute ``P_g`` —
the set of *largest feasible unallocated partitions* that can be (re-)
partitioned to host new workloads.  Reproduces the paper's Algorithm 1:

    for each slice index k in order:
        if k is not partitioned:
            for profiles big -> small:
                if a type-i partition can be created at index k: place it
                hypothetically and add (c_i, m_i) to P_g

Paper example (Fig. 7): g1 = {1g.10gb@0, 1g.10gb@5, 1g.10gb@6} yields
``P_g1 = [1g.10gb@1, 2g.20gb@2, 1g.10gb@4]``; g2 = {1g.20gb@6} yields
``P_g2 = [4g.40gb@0, 2g.20gb@4]`` and, merged, ``{6g.60gb}``.

Each output partition keeps its concrete memory-position span so that the
indexing step can verify real placements inside it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .profiles import DeviceModel, Profile
from .state import GPUState

__all__ = ["FreePartition", "determine_free_partitions", "merge_partitions"]


@dataclasses.dataclass(frozen=True)
class FreePartition:
    """An unallocated feasible partition on a partially-used GPU (one bin)."""

    pid: str  # unique id, e.g. "gpu3/p0"
    gid: str  # owning GPU
    span: Tuple[int, ...]  # memory positions covered
    compute_capacity: int  # usable compute slices within the span
    memory_capacity: int  # memory slices within the span
    merged: bool = False

    @property
    def start(self) -> int:
        return self.span[0]

    def contains_span(self, mem: range) -> bool:
        return set(mem) <= set(self.span)

    def admits(self, profile: Profile, device: DeviceModel) -> bool:
        """Can one partition of ``profile`` be created inside this span?"""
        if profile.compute_slices > self.compute_capacity:
            return False
        if profile.memory_slices > self.memory_capacity:
            return False
        for idx in profile.allowed_indexes:
            mem, _ = profile.span(idx, device.n_gpu_slices)
            if self.contains_span(mem):
                return True
        return False


def determine_free_partitions(gpu: GPUState, prefix: str = "") -> List[FreePartition]:
    """Algorithm 1 — ``P_g`` for one partially-partitioned GPU."""
    device = gpu.device
    hypo = gpu.clone()
    out: List[FreePartition] = []
    profiles = [p for p in device.profiles_sorted_desc() if not p.media_extensions]
    for k in range(device.n_gpu_slices):
        if hypo.memory_occupancy()[k] is not None:
            continue
        for prof in profiles:  # big -> small (sorted list of profile ids)
            if hypo.can_place_at(prof, k):
                hypo.place(f"_hypo{k}", prof.profile_id, k)
                mem, gpus = prof.span(k, device.n_gpu_slices)
                out.append(
                    FreePartition(
                        pid=f"{prefix}{gpu.gid}/p{len(out)}",
                        gid=gpu.gid,
                        span=tuple(mem),
                        compute_capacity=len(gpus),
                        memory_capacity=len(mem),
                    )
                )
                break
    # Trailing free memory position (m7) with free slice 6 is covered by the
    # k=6 iteration (profiles that extend into m7).  A stranded m7 (slice 6
    # occupied, m7 free) is unusable and yields no partition.
    return out


def merge_partitions(
    parts: List[FreePartition], device: DeviceModel
) -> List[FreePartition]:
    """Merge memory-contiguous free partitions of one GPU into bigger bins.

    The merged set reduces MIP variable count (paper Sec 4).  Merged bins may
    admit index-infeasible contents; callers must verify with the indexing
    step and fall back to the unmerged set on failure.
    """
    by_gpu: dict = {}
    for p in parts:
        by_gpu.setdefault(p.gid, []).append(p)
    merged: List[FreePartition] = []
    for gid, plist in by_gpu.items():
        plist = sorted(plist, key=lambda p: p.start)
        run: List[FreePartition] = []
        for p in plist:
            if run and run[-1].span[-1] + 1 == p.start:
                run.append(p)
            else:
                merged.extend(_fuse(run, gid))
                run = [p]
        merged.extend(_fuse(run, gid))
    return merged


def _fuse(run: List[FreePartition], gid: str) -> List[FreePartition]:
    if not run:
        return []
    if len(run) == 1:
        return list(run)
    span: Tuple[int, ...] = tuple(
        pos for p in run for pos in p.span
    )
    return [
        FreePartition(
            pid=f"{gid}/m{run[0].start}",
            gid=gid,
            span=span,
            compute_capacity=sum(p.compute_capacity for p in run),
            memory_capacity=sum(p.memory_capacity for p in run),
            merged=True,
        )
    ]
