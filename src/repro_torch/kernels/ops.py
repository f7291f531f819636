"""Kernel dispatch: one call site for the model code.

Counterpart of ``repro/kernels/ops.py``.  There is no global switch: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes the
plain version.  No ``try`` falls back from one to the other.  Under autograd
a CUDA tensor's flash attention and SSD scan go through their
``torch.autograd.Function`` (the kernel forward, a plain backward); the
decode kernels raise there.  Every kernel keeps an integer launch count,
read with ``launch_counts()``.

Under a mesh (``distribution.sharding.use_mesh``) every kernel takes
``DTensor`` inputs.  They reach the kernels through
``torch.distributed.tensor.experimental.local_map``: the inputs are
sharded by batch over the data axes when the batch divides, and by heads
over ``model`` when the head counts divide, replicated otherwise (the
reference's divisibility rule); a decode's cache length is replicated
(sharded with the batch where it is one length per slot).  Each rank's
kernel then runs on its own rows and heads, and counts its launches (on
``meta`` tensors, books them); no input is gathered whole to reach a
kernel.
"""
from __future__ import annotations

import math

import torch

from ..distribution import sharding
from ._build import launch_counts, reset_launch_counts
from .decode_attention import decode_attention as _decode_attention
from .decode_attention_q8 import decode_attention_q8 as _decode_attention_q8
from .flash_attention import flash_attention as _flash_attention
from .ssd_scan import ssd_scan as _ssd_scan

__all__ = [
    "flash_attention", "decode_attention", "decode_attention_q8", "cross_attention",
    "ssd_scan", "launch_counts", "reset_launch_counts",
]


def _local_layout(mesh, batch: int, heads_divide: bool):
    """The spec entries of a kernel input's batch dim (the data axes, or
    None) and heads dim ("model", or None) on ``mesh``."""
    sizes = sharding.mesh_axes(mesh)
    daxes = sharding.data_axes(mesh)
    dp = math.prod(sizes[a] for a in daxes)
    bax = None
    if daxes and dp > 1 and batch % dp == 0:
        bax = daxes if len(daxes) > 1 else daxes[0]
    m = sizes.get("model", 1)
    hax = "model" if m > 1 and heads_divide else None
    return bax, hax


def flash_attention(q, k, v, causal: bool = True, sliding_window=None):
    """Flash attention on plain tensors, or on DTensors through ``local_map``
    (each rank attends its own batch rows and heads)."""
    if not sharding.is_dtensor(q):
        return _flash_attention(q, k, v, causal, sliding_window)
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    m = sharding.mesh_axes(mesh).get("model", 1)
    bax, hax = _local_layout(mesh, q.shape[0], q.shape[2] % m == 0 and k.shape[2] % m == 0)
    pl = sharding.placements((bax, None, hax, None), mesh)
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))

    def local(q, k, v):
        return _flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                                sliding_window)

    return local_map(local, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=mesh)(q, k, v)


def _decode_local(kernel, q, caches, length):
    """``kernel(q, *caches, length)`` per rank through ``local_map``: q and
    the caches by batch and KV heads, a DTensor length replicated (by batch
    where it is one length per slot), a plain length handed to every rank."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    m = sharding.mesh_axes(mesh).get("model", 1)
    bax, hax = _local_layout(mesh, q.shape[0], q.shape[2] % m == 0 and caches[0].shape[2] % m == 0)
    placements = sharding.placements
    pls = [placements((bax, None, hax, None)[:t.dim()], mesh) for t in (q, *caches)]
    args = [t.redistribute(mesh, pl) for t, pl in zip((q, *caches), pls)]
    out_pl = pls[0]
    if sharding.is_dtensor(length):
        lpl = placements((bax,) if length.dim() == 1 else (), mesh)
        args.append(length.redistribute(mesh, lpl))
        pls.append(lpl)

        def local(q, *rest):
            return kernel(q.contiguous(), *(t.contiguous() for t in rest[:-1]), rest[-1])
    else:
        def local(q, *rest):
            return kernel(q.contiguous(), *(t.contiguous() for t in rest), length)

    return local_map(local, out_placements=list(out_pl), in_placements=tuple(pls),
                     device_mesh=mesh)(*args)


def decode_attention(q, k, v, length):
    """Flash decoding on plain tensors, or on DTensors through ``local_map``
    (each rank attends its own slots and KV heads)."""
    if not sharding.is_dtensor(q):
        return _decode_attention(q, k, v, length)
    return _decode_local(_decode_attention, q, (k, v), length)


def decode_attention_q8(q, k_q, k_s, v_q, v_s, length):
    """The int8-cache decode on plain tensors, or on DTensors through
    ``local_map`` as ``decode_attention``."""
    if not sharding.is_dtensor(q):
        return _decode_attention_q8(q, k_q, k_s, v_q, v_s, length)
    return _decode_local(_decode_attention_q8, q, (k_q, k_s, v_q, v_s), length)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention(q, k, v, causal=False, sliding_window=None)


def ssd_scan(x, dt, A, B, C, initial_state=None):
    """The SSD scan on plain tensors, or on DTensors through ``local_map``:
    x, dt and the state sharded by batch and heads, B and C by batch, A by
    heads.  A gradient of an input replicated over a mesh axis that the
    rank's work splits is a partial sum there."""
    if not sharding.is_dtensor(x):
        return _ssd_scan(x, dt, A, B, C, initial_state)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    placements = sharding.placements
    mesh = x.device_mesh
    m = sharding.mesh_axes(mesh).get("model", 1)
    bax, hax = _local_layout(mesh, x.shape[0], x.shape[2] % m == 0)
    specs = [(bax, None, hax, None), (bax, None, hax), (hax,), (bax, None, None),
             (bax, None, None)]
    if initial_state is not None:
        specs.append((bax, hax, None, None))
    pls = [placements(s, mesh) for s in specs]
    args = [t.redistribute(mesh, pl) for t, pl in zip(
        (x, dt, A, B, C) + ((initial_state,) if initial_state is not None else ()), pls)]

    def partial_over(spec, axes):
        """The placements of ``spec`` with each mesh axis in ``axes`` that
        the spec leaves replicated turned into a partial sum."""
        pl = list(placements(spec, mesh))
        named = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        for i, a in enumerate(mesh.mesh_dim_names):
            if a in axes and a not in named:
                pl[i] = Partial()
        return tuple(pl)

    split = set(((bax,) if isinstance(bax, str) else (bax or ()))) | ({hax} if hax else set())
    grads = [pl if i in (0, 1, 5) else partial_over(specs[i], split)
             for i, pl in enumerate(pls)]

    def local(x, dt, A, B, C, init=None):
        return _ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(),
                         C.contiguous(), None if init is None else init.contiguous())

    out_pl = (pls[0], placements((bax, hax, None, None), mesh))
    return local_map(local, out_placements=out_pl, in_placements=tuple(pls),
                     in_grad_placements=tuple(grads), device_mesh=mesh)(*args)
