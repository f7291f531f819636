"""Train-step factory: gradient accumulation over microbatches, block
rematerialization, AdamW update.  Counterpart of
``repro/training/train_loop.py``.

The returned step is functional, (params, opt_state, batch) -> (params,
opt_state, metrics), as the reference's: the parameters it is given are
left as they are.  It differentiates with ``torch.autograd.grad``, so no
``.grad`` accumulates on the leaves.  On one device the data-parallel
degree is 1; the reference's mesh hooks (``_dp_degree``,
``_constrain_micro``, ``_constrain_like``: microbatches rounded to the
data-parallel degree and sharding constraints on microbatches and
gradients) come with the distribution layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

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


def _n_micro(bsz: int, microbatch: int) -> int:
    """Microbatches per step: the smallest size >= ``microbatch`` that
    divides the batch (the reference's rounding with a data-parallel degree
    of 1)."""
    if not microbatch:
        return 1
    mbsz = max(microbatch, 1)
    while bsz % mbsz and mbsz < bsz:
        mbsz += 1
    return max(1, bsz // mbsz)


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
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        bsz = batch["tokens"].shape[0]
        n_micro = _n_micro(bsz, train_cfg.microbatch)
        if n_micro > 1:
            mbsz = bsz // n_micro
            gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(n_micro):
                micro = {k: v[i * mbsz:(i + 1) * mbsz] for k, v in batch.items()}
                loss, grads = loss_and_grads(leaves, params, micro)
                for a, g in zip(gsum, grads):
                    a.add_(g.to(acc_dt))
                lsum = lsum + loss.detach()
            grads = [g / n_micro for g in gsum]
            loss = lsum / n_micro
        else:
            loss, grads = loss_and_grads(leaves, params, batch)
            loss = loss.detach()
        params2, opt_state2, om = opt.apply(params, tree_unflatten(params, grads), opt_state,
                                            opt_cfg)
        return params2, opt_state2, {"loss": loss, **om}

    return train_step
