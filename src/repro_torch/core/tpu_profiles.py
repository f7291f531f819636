"""TPU adaptation of the MIG device model.  Copy of
``repro/core/tpu_profiles.py``: the reference's default device, kept for
parity, and ``profile_for_chips``, which sizes replicas on any device model.

A v5e pod (16x16 torus) is partitioned into contiguous row-blocks.  The
analogy to MIG is structural:

  * slice       -> one pod row (16 chips, 16 GB HBM each => 256 GB / row)
  * profile     -> row-block height in {16, 8, 4, 2, 1}
  * allowed idx -> aligned start rows (start % height == 0) so the block is a
                   contiguous sub-torus whose ICI wrap links remain usable —
                   the same "only certain indices" constraint MIG imposes
  * preference  -> descending start row (buddy-allocator discipline: keeps
                   low-index space contiguous for large future blocks, the
                   paper's availability objective 3)

Differences from MIG, as required by the hardware: HBM is uniform
per chip, so there is no extra-memory slice (``extra_memory=False``) and
compute/memory slices are always 1:1 — the asymmetric-profile wastage terms
are exercised only by the faithful MIG instantiation.  Wastage on TPU is
fragmentation, which the availability objective captures.
"""
from __future__ import annotations

from typing import Tuple

from .profiles import DeviceModel, Profile

__all__ = ["TPU_V5E_POD", "profile_for_chips"]


def _aligned(height: int, n_rows: int = 16) -> Tuple[int, ...]:
    return tuple(sorted(range(0, n_rows, height), reverse=True))


_TPU_PROFILES = (
    Profile(0, 0, "16x16.4096gb", 16, 16, (0,)),
    Profile(1, 1, "8x16.2048gb", 8, 8, _aligned(8)),
    Profile(2, 2, "4x16.1024gb", 4, 4, _aligned(4)),
    Profile(3, 3, "2x16.512gb", 2, 2, _aligned(2)),
    Profile(4, 4, "1x16.256gb", 1, 1, _aligned(1)),
)

TPU_V5E_POD = DeviceModel(
    name="TPUv5e-16x16-pod",
    n_gpu_slices=16,  # rows
    n_memory_slices=16,
    mem_per_slice_gb=256,  # 16 chips x 16 GB HBM
    profiles=_TPU_PROFILES,
    extra_memory=False,
    max_media_extensions=0,
)


def profile_for_chips(hbm_bytes_needed: int, device: DeviceModel = TPU_V5E_POD) -> Profile:
    """Smallest row-block profile whose HBM fits the requirement."""
    for prof in sorted(device.profiles, key=lambda p: p.memory_slices):
        if prof.memory_slices * device.mem_per_slice_gb * (1 << 30) >= hbm_bytes_needed:
            return prof
    return device.profiles_sorted_desc()[0]  # full pod
