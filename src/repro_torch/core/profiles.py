"""MIG partition profiles and device slice geometry (paper Table 1, Sec 2.1/3.2).
Copy of ``repro/core/profiles.py`` with one addition: ``H100_80GB``, the
MIG geometry of the card the port serves on.

Geometry model
--------------
A MIG-enabled GPU exposes ``n_gpu_slices`` positional *GPU slices* (A100/H100:
7, indexes 0..6) and ``n_memory_slices`` *memory positions* (A100/H100: 8,
positions 0..7).  GPU slice ``i`` owns memory position ``i``; the extra memory
position (m7) is physically attached to GPU slice 6 and is only usable by a
partition that includes the last slice (paper constraint 3.2.3).

A partition of profile ``p`` placed at index ``k`` covers memory positions
``[k, k + p.memory_slices)`` and GPU slices ``[k, min(k + p.memory_slices,
n_gpu_slices))``.  This single rule reproduces the paper's Table 1 exactly:

* ``3g.40gb`` (profile 9) at index 4 covers memory {4,5,6,7} and GPU slices
  {4,5,6}: 3 compute slices, no waste.  At index 0 it covers GPU slices
  {0,1,2,3} but provides only 3 compute slices -> 1 compute slice wasted.
* ``1g.20gb`` (profile 15) at index 6 covers memory {6,7} and GPU slice {6}:
  no waste; anywhere else it blocks 2 GPU slices for 1 compute -> 1 wasted.
* ``1g.10gb`` (profile 19) at index 6 covers memory {6} only, stranding m7
  -> 1 memory slice wasted (Table 3 note).

The model is deliberately abstract (``DeviceModel``) so it can be
instantiated for the paper's A100/H100 MIG geometry *and* for the TPU
pod-partition adaptation (``tpu_profiles.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

__all__ = [
    "Profile",
    "DeviceModel",
    "A100_80GB",
    "H100_96GB",
    "H100_80GB",
    "PROFILE_BY_ID",
]


@dataclasses.dataclass(frozen=True, order=True)
class Profile:
    """A MIG partition profile (one row of paper Table 1)."""

    sort_key: int = dataclasses.field(repr=False)  # sorts big->small like Table 1
    profile_id: int
    name: str
    compute_slices: int
    memory_slices: int
    #: preference-ordered allowed start indexes (paper Table 1, last column).
    allowed_indexes: Tuple[int, ...]
    #: media-extension profile (at most one per GPU); third bin-pack dimension.
    media_extensions: int = 0

    @property
    def gpu_slices(self) -> int:
        """Positional footprint as listed in Table 1 (placement at index 0)."""
        return min(self.memory_slices, 7)

    def span(self, index: int, n_gpu_slices: int = 7) -> Tuple[range, range]:
        """(memory positions, GPU slices) covered when placed at ``index``."""
        mem = range(index, index + self.memory_slices)
        gpu = range(index, min(index + self.memory_slices, n_gpu_slices))
        return mem, gpu

    def compute_waste_at(self, index: int, n_gpu_slices: int = 7) -> int:
        """Blocked-but-unusable compute slices for a placement at ``index``."""
        _, gpu = self.span(index, n_gpu_slices)
        return len(gpu) - self.compute_slices


def _mk_profiles(mem_per_slice_gb: int) -> Tuple[Profile, ...]:
    """Table 1 for A100/H100-class GPUs (7 GPU slices / 8 memory slices)."""
    m = mem_per_slice_gb
    return (
        Profile(0, 0, f"7g.{8 * m}gb", 7, 8, (0,)),
        Profile(1, 5, f"4g.{4 * m}gb", 4, 4, (0,)),
        Profile(2, 9, f"3g.{4 * m}gb", 3, 4, (4, 0)),
        Profile(3, 14, f"2g.{2 * m}gb", 2, 2, (4, 0, 2)),
        Profile(4, 15, f"1g.{2 * m}gb", 1, 2, (6, 4, 0, 2)),
        Profile(5, 19, f"1g.{m}gb", 1, 1, (6, 4, 5, 0, 1, 2, 3)),
        Profile(6, 20, f"1g.{m}gb+me", 1, 1, (6, 4, 5, 0, 1, 2, 3), media_extensions=1),
    )


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Abstract partitionable accelerator (a 'bin' in the paper's sense)."""

    name: str
    n_gpu_slices: int  # C_g: total compute slices (A100: 7)
    n_memory_slices: int  # memory positions (A100: 8)
    mem_per_slice_gb: int  # S_g
    profiles: Tuple[Profile, ...]
    #: whether an extra memory position exists beyond the GPU slices (m7).
    extra_memory: bool = True
    max_media_extensions: int = 1

    @property
    def total_memory_gb(self) -> int:  # M_g
        return self.n_memory_slices * self.mem_per_slice_gb

    @functools.cached_property
    def by_id(self) -> Dict[int, Profile]:
        # cached_property writes through the instance __dict__, which frozen
        # dataclasses permit; profile() sits on every placement hot path.
        return {p.profile_id: p for p in self.profiles}

    def profile(self, profile_id: int) -> Profile:
        return self.by_id[profile_id]

    def profiles_sorted_desc(self) -> Tuple[Profile, ...]:
        """Profiles sorted by descending size (= ascending profile id, Table 1)."""
        return tuple(sorted(self.profiles, key=lambda p: p.sort_key))

    def fits(self, counts: Dict[int, int]) -> bool:
        """Pure bin-packing feasibility across resource dimensions (Assump. 1)."""
        c = sum(self.profile(i).compute_slices * n for i, n in counts.items())
        mem = sum(self.profile(i).memory_slices * n for i, n in counts.items())
        me = sum(self.profile(i).media_extensions * n for i, n in counts.items())
        return (
            c <= self.n_gpu_slices
            and mem <= self.n_memory_slices
            and me <= self.max_media_extensions
        )


A100_80GB = DeviceModel(
    name="A100-80GB",
    n_gpu_slices=7,
    n_memory_slices=8,
    mem_per_slice_gb=10,
    profiles=_mk_profiles(10),
)

H100_96GB = DeviceModel(
    name="H100-96GB",
    n_gpu_slices=7,
    n_memory_slices=8,
    mem_per_slice_gb=12,
    profiles=_mk_profiles(12),
)

#: The H100 80GB's MIG table (NVIDIA MIG user guide): 1g.10gb (19),
#: 1g.10gb+me (20), 1g.20gb (15), 2g.20gb (14), 3g.40gb (9), 4g.40gb (5),
#: 7g.80gb (0) -- the A100 80GB's geometry and profile ids.  The port's
#: cluster server sizes and places replicas on it by default.
H100_80GB = DeviceModel(
    name="H100-80GB",
    n_gpu_slices=7,
    n_memory_slices=8,
    mem_per_slice_gb=10,
    profiles=_mk_profiles(10),
)

#: Convenience: A100 profile lookup (the paper's running example).
PROFILE_BY_ID: Dict[int, Profile] = A100_80GB.by_id
