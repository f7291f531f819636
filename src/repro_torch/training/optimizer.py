"""AdamW with configurable moment precision, including int8-quantized
moments with one f32 scale per leading row.  Counterpart of
``repro/training/optimizer.py``.

Functional, as the reference: ``apply`` returns new parameter and state
trees and changes nothing it is given.  The update is computed in f32 and
cast back to each parameter's dtype; weight decay touches matrices only
(ndim >= 2); ``step`` is an int32 scalar.  ``torch.round`` and ``jnp.round``
both round half to even, so the int8 codes equal the reference's bit for
bit on the same moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

Params = Any

__all__ = ["AdamWConfig", "init", "schedule", "global_norm", "apply"]

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16 | int8
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------------
# int8 block quantization (per leading-row scale)
# ---------------------------------------------------------------------------
def _row_dims(x: torch.Tensor):
    """The dims one scale spans: all but the leading row (a 1-D leaf is one
    row)."""
    return tuple(range(1, x.dim())) if x.dim() > 1 else (0,)


def _n_rows(x: torch.Tensor) -> int:
    return x.shape[0] if x.dim() > 1 else 1


def _q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int8 quantization with one f32 scale per row (axis 0 kept):
    {"q": int8 like x, "scale": f32 (rows, 1)}.  The amax runs over the
    row's dims in place, never through a reshape: on a DTensor that shards
    them it is one all-reduce of the maxima."""
    xf = x.float()
    scale = xf.abs().amax(dim=_row_dims(x), keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.reshape(_n_rows(x), 1)}


def _dq8(packed: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    q = packed["q"]
    lead = (_n_rows(q),) + (1,) * (q.dim() - 1) if q.dim() > 1 else (1,)
    return q.float() * packed["scale"].reshape(lead)


def _encode_moment(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8(x)
    return x.to(_MOMENT_DTYPES[dtype])


def _decode_moment(m, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dq8(m, shape)
    return m.float()


def _is_moment_leaf(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _moment_leaves(tree):
    """The moments in the parameter tree's leaf order, an int8 moment's
    {"q", "scale"} dict counting as one leaf."""
    if _is_moment_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _moment_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _moment_leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def init(params: Params, cfg: AdamWConfig) -> Params:
    def zero_like(p):
        # zeros_like keeps a DTensor's placements: each rank makes its shard
        return _encode_moment(torch.zeros_like(p, dtype=torch.float32), cfg.moment_dtype)

    device = next(iter(tree_leaves(params))).device
    return {
        "m": tree_map(zero_like, params),
        "v": tree_map(zero_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac`` x lr at ``decay_steps``; f32, as the reference."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def apply(
    params: Params, grads: Params, state: Params, cfg: AdamWConfig
) -> Tuple[Params, Params, Dict[str, torch.Tensor]]:
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}).  The
    gradients are clipped to a global norm of ``grad_clip`` first."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    lr = schedule(step, cfg)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    new_p, new_m, new_v = [], [], []
    for p, g, m_enc, v_enc in zip(tree_leaves(params), tree_leaves(grads),
                                  _moment_leaves(state["m"]), _moment_leaves(state["v"])):
        g = g.float() * clip
        m = _decode_moment(m_enc, p.shape, cfg.moment_dtype)
        v = _decode_moment(v_enc, p.shape, cfg.moment_dtype)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:  # decay matrices only
            upd = upd + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * upd).to(p.dtype))
        new_m.append(_encode_moment(m, cfg.moment_dtype))
        new_v.append(_encode_moment(v, cfg.moment_dtype))

    state2 = {"m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v),
              "step": step}
    return tree_unflatten(params, new_p), state2, {"grad_norm": gnorm, "lr": lr}
