"""Mixture-of-Experts layer: router + capacity-bounded expert dispatch.
Counterpart of ``repro/models/moe.py``.  ``set_moe_impl`` picks the mode:
``"dispatch"`` (default, below) or ``"alltoall"``, the expert-parallel
layer of ``distribution/moe_ep.py``, which falls back to dispatch where no
mesh applies.

GShard/MaxText-style grouped one-hot dispatch: tokens are split into G
groups of about 1024; dispatch and combine are dense einsums over
(group, token, expert, capacity) masks in the model's dtype.  Tokens beyond
an expert's per-group capacity C = ceil(Tg*k/E * cf) are dropped
(contribute zero), with token-major priority -- the standard Switch/GShard
discipline.  Every expert runs on its C slots whether they hold a token or
not, so a step reads every expert's weights, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distribution import sharding
from . import layers

__all__ = ["apply_moe", "set_moe_impl", "get_moe_impl"]

_MOE_IMPL = {"mode": "dispatch"}


def set_moe_impl(mode: str) -> None:
    if mode not in ("dispatch", "alltoall"):
        raise ValueError(f"set_moe_impl: 'dispatch' or 'alltoall', got {mode!r}")
    _MOE_IMPL["mode"] = mode


def get_moe_impl() -> str:
    return _MOE_IMPL["mode"]


def _route(p: Dict[str, Any], xt: torch.Tensor, cfg: ArchConfig):
    """f32 router: (T,D) -> gates (T,k) renormalised, experts (T,k), and the
    Switch load-balancing loss E * sum_e f_e * P_e."""
    logits = xt.float() @ p["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # torch.topk leaves the order of tied values unspecified where
    # jax.lax.top_k takes the lower index first; random f32 router logits
    # make an exact tie vanishingly rare, so the two agree
    gates, eidx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(0)
    aux = cfg.n_experts * torch.sum(me * _expert_share(eidx, me))
    return gates, eidx, aux


def _expert_share(eidx: torch.Tensor, me: torch.Tensor) -> torch.Tensor:
    """The share of routed slots that picked each expert, (E,) f32.  A
    DTensor counts them as a one-hot sum, a partial sum over the ranks that
    split the tokens: DTensor has no sharding rule for ``index_add_``, and
    torch 2.11 cannot shard it through its decomposition fallback either.
    The counts are integers, exact either way."""
    if sharding.is_dtensor(eidx):
        counts = F.one_hot(eidx.reshape(-1), me.shape[0]).sum(0)
        return counts.to(me.dtype) / eidx.numel()
    return torch.zeros_like(me).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), device=eidx.device)) / eidx.numel()


def _expert_ffn(experts: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """h (E,...,D) -> (E,...,D) via per-expert SwiGLU (batched matmuls)."""
    shape = h.shape
    hf = h.reshape(shape[0], -1, shape[-1])
    a = F.silu(torch.bmm(hf, experts["w_gate"])) * torch.bmm(hf, experts["w_up"])
    return torch.bmm(a, experts["w_out"]).reshape(shape)


def _group_count(t: int) -> int:
    """~1024-token groups, power-of-two, >= 1."""
    g = max(1, t // 1024)
    return 1 << (g - 1).bit_length() if g & (g - 1) else g


def apply_moe(
    p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y, aux_loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, eidx, aux = _route(p, xt, cfg)
    if _MOE_IMPL["mode"] == "alltoall":
        from ..distribution import moe_ep

        y = moe_ep.apply_moe_alltoall(p, xt, gates, eidx, cfg)
    else:
        y = _apply_dispatch(p, xt, gates, eidx, cfg)
    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], xt, "swiglu")
    return y.reshape(b, s, d).to(x.dtype), aux


def _apply_dispatch(p, xt: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """GShard grouped dense dispatch/combine."""
    t, d = xt.shape
    k, e = cfg.experts_per_token, cfg.n_experts
    g = _group_count(t)
    tg = t // g
    cap = max(4, int(math.ceil(tg * k / e * cfg.capacity_factor)))
    cap = min(cap, tg * k)

    eidx_g = eidx.reshape(g, tg, k)
    gates_g = gates.reshape(g, tg, k)
    x_g = layers.hint(xt.reshape(g, tg, d), "batch", None, None)

    onehot = F.one_hot(eidx_g, e).float()  # (g, tg, k, e)
    onehot = layers.hint(onehot, "batch", None, None, "experts")
    # position of each slot within its expert's buffer (token-major
    # priority): an exclusive cumsum, exact in f32 below 2**24
    flat = onehot.reshape(g, tg * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, tg, k, e)
    keep = (pos < cap) & (onehot > 0)
    # a token picks an expert in at most one top-k slot, so the k axis
    # collapses: (g, tg, e)
    sel = keep.any(2)
    pos_te = (pos * keep).sum(2).long()
    gate_te = (gates_g[..., None] * keep).sum(2)

    dispatch = F.one_hot(pos_te, cap).float() * sel[..., None]  # (g, tg, e, cap)
    dispatch = layers.hint(dispatch, "batch", None, "experts", None)
    combine = dispatch * gate_te[..., None]

    dt = xt.dtype
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(dt), x_g)
    expert_in = layers.hint(expert_in.transpose(0, 1), "experts", "batch", None, None)
    expert_out = _expert_ffn(p["experts"], expert_in)  # (e, g, cap, d)
    expert_out = expert_out.transpose(0, 1)  # (g, e, cap, d)
    if sharding.is_dtensor(combine):
        # the same contraction with (e, cap) flattened experts first: torch
        # 2.11's DTensor refuses the einsum's (cap, e) flattening of a
        # tensor sharded over the experts
        y = combine.to(dt).reshape(g, tg, e * cap) @ expert_out.reshape(g, e * cap, d)
    else:
        y = torch.einsum("gtec,gecd->gtd", combine.to(dt), expert_out)
    return y.reshape(t, d)
