"""Train-step factory: gradient accumulation over microbatches, block
rematerialization, AdamW update.  Counterpart of
``repro/training/train_loop.py``.

The returned step is functional, (params, opt_state, batch) -> (params,
opt_state, metrics), as the reference's: the parameters it is given are
left as they are.  It differentiates with ``torch.autograd.grad``, so no
``.grad`` accumulates on the leaves.

Under ``distribution.sharding.use_mesh`` the parameters, optimizer state
and batch are DTensors (``sharding.distribute``, ``data.shard_batch``) and
the reference's mesh hooks apply: the microbatch size is rounded up to a
multiple of the data-parallel degree that divides the batch
(``_dp_degree``), microbatch i is global rows i*mbsz ... (i+1)*mbsz - 1
sharded over the data axes (``_constrain_micro``), and the gradients take
their parameters' placements (``_constrain_like``: under fsdp their
reduction is a reduce-scatter).  The new parameters and optimizer state
leave the step with their specs' placements, as the reference's
``out_shardings`` give them; the metrics are plain tensors.  On a mesh of
one rank everything stays plain and the step is the unsharded one.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List

import torch

from ..distribution import sharding
from ..models import transformer
from ..models.model_zoo import ModelBundle
from ..tree import tree_leaves, tree_unflatten
from . import optimizer as opt

Params = Any

__all__ = ["TrainConfig", "make_train_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0  # global microbatch size; 0 = single shot
    remat: bool = True
    accum_dtype: str = "float32"


def _n_micro(bsz: int, microbatch: int, dp: int = 1) -> int:
    """Microbatches per step: each must stay shardable over the whole
    data-parallel degree ``dp``, so the microbatch size is rounded up to a
    multiple of dp that divides the batch (the reference's rounding)."""
    if not microbatch:
        return 1
    mbsz = max(microbatch, dp)
    mbsz = -(-mbsz // dp) * dp
    while bsz % mbsz and mbsz < bsz:
        mbsz += dp
    return max(1, bsz // mbsz)


def _dp_degree() -> int:
    """Total data-parallel shards (pod x data) of the ambient mesh."""
    ctx = sharding.current()
    if ctx is None:
        return 1
    sizes = sharding.mesh_axes(ctx["mesh"])
    n = 1
    for a in sharding.data_axes(ctx["mesh"]):
        n *= sizes[a]
    return n


def _constrain_micro(x: torch.Tensor, n_micro: int) -> List[torch.Tensor]:
    """The n_micro microbatches of one batch leaf: microbatch i is global
    rows i*mbsz ... (i+1)*mbsz - 1, as the reference's reshape gives, with
    its rows sharded over the data axes when they divide.  A sharded leaf is
    gathered first: the batch is int32 tokens (and frontend inputs), small
    beside the activations, and the reference's reshape moves them too."""
    mbsz = x.shape[0] // n_micro
    if not sharding.is_dtensor(x):
        return [x[i * mbsz:(i + 1) * mbsz] for i in range(n_micro)]
    mesh = x.device_mesh
    full = x.full_tensor()
    daxes = sharding.data_axes(mesh)
    entry = None
    if daxes and mbsz % _dp_degree() == 0:
        entry = daxes if len(daxes) > 1 else daxes[0]
    spec = (entry,) + (None,) * (x.dim() - 1)
    return [sharding.distribute(full[i * mbsz:(i + 1) * mbsz], spec, mesh)
            for i in range(n_micro)]


def _constrain_like(grads, params):
    """Each gradient in its parameter's placements (a plain gradient is
    left as it is): a partial sum over the data axes becomes a reduce-scatter
    under fsdp and an all-reduce without it."""
    return [g.redistribute(p.device_mesh, p.placements) if sharding.is_dtensor(g) else g
            for g, p in zip(grads, params)]


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if sharding.is_dtensor(x) else x


def _region():
    """Plain tensors (positions, masks, constants: the same on every rank)
    count as replicated beside DTensors inside a sharded step."""
    ctx = sharding.current()
    if ctx is None or sharding.is_trivial(ctx["mesh"]):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_train_step(mb: ModelBundle, opt_cfg: opt.AdamWConfig,
                    train_cfg: TrainConfig) -> Callable:
    """As the reference, ``remat`` sets ``transformer.set_remat("block")``
    for the whole process."""
    if train_cfg.remat:
        transformer.set_remat("block")
    acc_dt = _DTYPES[train_cfg.accum_dtype]

    def loss_and_grads(leaves, template, batch):
        params = tree_unflatten(template, leaves)
        loss, _ = mb.loss_fn(params, batch)
        return loss, torch.autograd.grad(loss, leaves)

    def train_step(params: Params, opt_state: Params, batch: Dict[str, torch.Tensor]):
        with _region():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        bsz = batch["tokens"].shape[0]
        n_micro = _n_micro(bsz, train_cfg.microbatch, _dp_degree())
        if n_micro > 1:
            micro = {k: _constrain_micro(v, n_micro) for k, v in batch.items()}
            gsum = [torch.zeros_like(p, dtype=acc_dt, requires_grad=False) for p in leaves]
            lsum = None
            for i in range(n_micro):
                loss, grads = loss_and_grads(leaves, params, {k: v[i] for k, v in micro.items()})
                for a, g in zip(gsum, _constrain_like(grads, leaves)):
                    a.add_(g.to(acc_dt))
                lsum = loss.detach() if lsum is None else lsum + loss.detach()
            grads = [g / n_micro for g in gsum]
            loss = lsum / n_micro
        else:
            loss, grads = loss_and_grads(leaves, params, batch)
            grads = _constrain_like(grads, leaves)
            loss = loss.detach()
        params2, opt_state2, om = opt.apply(params, tree_unflatten(params, grads), opt_state,
                                            opt_cfg)
        ctx = sharding.current()
        if ctx is not None and not sharding.is_trivial(ctx["mesh"]):
            mesh, fsdp = ctx["mesh"], ctx["fsdp"]
            params2 = sharding.distribute(params2, sharding.param_specs(params2, mesh, fsdp),
                                          mesh)
            opt_state2 = sharding.distribute(
                opt_state2, sharding.opt_state_specs(params2, opt_state2, mesh, fsdp), mesh)
        return params2, opt_state2, {"loss": _plain(loss),
                                     **{k: _plain(v) for k, v in om.items()}}

    return train_step
