"""GPipe pipeline parallelism over the ``pod`` mesh axis.  Counterpart of
``repro/distribution/pipeline.py``.

The multi-pod mesh's ``pod`` axis is the slow boundary: the traffic that
belongs on it is data-parallel gradient reduction or pipeline activations.
This module carries the latter: layers are split into one stage per pod
rank, and microbatches stream through the stages with point-to-point
handoffs (the GPipe fill/drain schedule).

  y = gpipe(stage_fn, stage_params, x, mesh=mesh, n_micro=4)

``stage_params``: a tree whose leaves have a leading ``n_stages`` dim; each
rank applies the slice of its own stage (its coordinate on the stage
axis).  ``stage_fn(params_one_stage, x_mb) -> y_mb`` applies one stage.
``x``: (n_micro, mb, ...) microbatches, the same on every rank.  The bubble
fraction is GPipe's (S-1)/(S-1+M); pick n_micro >> n_stages.

Each rank runs the reference's loop of n_micro + S - 1 ticks: stage 0
ingests microbatch t, every stage applies itself, and its output goes to
the next stage with ``batch_isend_irecv`` over the stage axis's group
(where the reference uses ``ppermute``).  The last stage keeps microbatch
t - (S-1).  Its outputs are summed over the stage group at the end, so
every rank returns ``y``, as the reference's ``psum`` does.  Ranks that
differ only off the stage axis run the same stages on the same inputs.
The handoffs are not differentiable: this is a forward schedule, as the
reference's tests use it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..tree import tree_map
from . import sharding

__all__ = ["gpipe"]


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
          x: torch.Tensor, *, mesh, n_micro: int, stage_axis: str = "pod") -> torch.Tensor:
    n_stages = sharding.mesh_axes(mesh)[stage_axis]
    if x.shape[0] != n_micro:
        raise ValueError(f"gpipe: x must be (n_micro={n_micro}, mb, ...), got {tuple(x.shape)}")
    if n_stages == 1:
        # one stage: apply it to every microbatch
        p0 = tree_map(lambda a: a[0], stage_params)
        return torch.stack([stage_fn(p0, x[i]) for i in range(n_micro)])

    group = mesh.get_group(stage_axis)
    r = mesh.get_local_rank(stage_axis)
    nxt = dist.get_global_rank(group, r + 1) if r + 1 < n_stages else None
    prv = dist.get_global_rank(group, r - 1) if r > 0 else None
    p_local = tree_map(lambda a: a[r], stage_params)
    buf = torch.zeros_like(x[0])
    y = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (while there is one); the others
        # take what the previous stage handed over
        inp = x[min(t, n_micro - 1)] if r == 0 else buf
        out = stage_fn(p_local, inp)
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), nxt, group))
        if prv is not None:
            buf = torch.empty_like(x[0])
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        # the last stage emits microbatch t - (S - 1)
        oidx = t - (n_stages - 1)
        if r == n_stages - 1 and oidx >= 0:
            y[oidx] = out
    # the results live on the last stage; summing over the stage group
    # (zeros elsewhere) gives every rank y
    dist.all_reduce(y, group=group)
    return y
