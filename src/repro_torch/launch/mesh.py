"""Meshes.  Counterpart of ``repro/launch/mesh.py``.

Functions, never module constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the default process
group, which must already hold as many ranks as the mesh has.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_host_mesh", "make_production_mesh", "production_shape"]


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: one pod of 16 x 16 ranks
    as (data, model), or two pods as (pod, data, model), the pod axis the
    slow boundary (data parallel or pipeline stages)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """The production mesh over 256 (or 512) ranks."""
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """Every rank of the default process group as a 1-D ``data`` mesh."""
    return init_device_mesh(device, (dist.get_world_size(),), mesh_dim_names=("data",))
