"""Shared fleet construction (used by simulator, events and ``chip_smoke.py``).
Copy of ``repro/core/fleetgen.py``.

``core/simulator.py`` (random Sec-5.1 test cases) and ``core/events.py``
(online traces over possibly-mixed fleets) used to build clusters through
separate code paths; this module is the single builder both call.

gid naming is caller-controlled via ``gid_format`` so the two historical
schemes stay byte-identical:

  * test cases:  ``gpu{i}``   (``ClusterState.homogeneous`` style)
  * trace fleets: ``{tag}-{i}`` where tag is the lowercased device-name stem

Indexes continue across spec entries sharing a tag, so two ``(A100_80GB, n)``
entries yield distinct gids instead of colliding.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .profiles import DeviceModel
from .state import ClusterState, GPUState

__all__ = ["FleetSpec", "build_fleet"]

#: (device model, count) pairs describing a possibly-mixed fleet.
FleetSpec = Sequence[Tuple[DeviceModel, int]]


def build_fleet(spec: FleetSpec, gid_format: str = "{tag}-{i}") -> ClusterState:
    """A (possibly heterogeneous) cluster from (device, count) pairs."""
    gpus: Dict[str, GPUState] = {}
    next_i: Dict[str, int] = {}
    for device, count in spec:
        tag = device.name.split("-")[0].lower()
        for _ in range(count):
            i = next_i.get(tag, 0)
            next_i[tag] = i + 1
            gid = gid_format.format(tag=tag, i=i)
            if gid in gpus:
                raise ValueError(f"gid collision {gid!r} (gid_format={gid_format!r})")
            gpus[gid] = GPUState(gid, device)
    return ClusterState(gpus=gpus)
