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


def flash_attention(q, k, v, causal: bool = True, sliding_window=None):
    """Flash attention on plain tensors, or on DTensors through ``local_map``
    (each rank attends its own batch rows and heads)."""
    if not sharding.is_dtensor(q):
        return _flash_attention(q, k, v, causal, sliding_window)
    bax, hax = sharding.local_layout(q, q.shape[2], k.shape[2])
    spec = (bax, None, hax, None)

    def local(q, k, v):
        return _flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                                sliding_window)

    return sharding.per_rank(local, (q, k, v), (spec,) * 3, spec)


def _decode_local(kernel, q, caches, length):
    """``kernel(q, *caches, length)`` per rank: q and the caches by batch
    and KV heads, a DTensor length replicated (by batch where it is one
    length per slot), a plain length handed to every rank."""
    bax, hax = sharding.local_layout(q, q.shape[2], caches[0].shape[2])
    spec = (bax, None, hax, None)
    specs = [spec[:t.dim()] for t in (q, *caches)]
    specs.append((bax,) if getattr(length, "dim", lambda: 0)() == 1 else ())

    def local(q, *rest):
        return kernel(q.contiguous(), *(t.contiguous() for t in rest[:-1]), rest[-1])

    return sharding.per_rank(local, (q, *caches, length), specs, spec)


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
    rank's work splits is a partial sum there (``sharding.per_rank``)."""
    if not sharding.is_dtensor(x):
        return _ssd_scan(x, dt, A, B, C, initial_state)
    bax, hax = sharding.local_layout(x, x.shape[2])
    specs = [(bax, None, hax, None), (bax, None, hax), (hax,), (bax, None, None),
             (bax, None, None), (bax, hax, None, None)]

    def local(x, dt, A, B, C, init):
        return _ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(),
                         C.contiguous(), None if init is None else init.contiguous())

    return sharding.per_rank(local, (x, dt, A, B, C, initial_state), specs,
                             [specs[0], specs[-1]])
