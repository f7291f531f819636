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

Two more behaviours, each selected by ``ArchConfig`` fields alone (the
defaults keep the above bit for bit):

  * DeepSeek-V3's ``noaux_tc`` router (``scoring_func`` "sigmoid",
    ``n_group`` > 1): sigmoid scores; a score-correction bias
    (``router_bias``) added only to choose; the experts split into
    ``n_group`` groups, each ranked by the sum of its two best biased
    scores and the best ``topk_group`` kept; the top k inside the kept
    groups; the gates taken from the unbiased scores, normalised over the k
    (``norm_topk_prob``) and scaled by ``routed_scaling_factor``.
  * the held-expert layer (``n_routed_experts`` set): the router scores all
    ``n_routed_experts`` experts (global ids), the layer holds
    ``n_experts`` of them from ``expert_offset`` (one rank's share of an
    expert-parallel deployment) and computes their part of the result for
    every (token, choice) routed to them, dropping none.  The routed rows
    are sorted by expert into a buffer of static size (no host
    synchronization) and the experts run as grouped GEMMs over the rows
    actually routed to them (``torch._grouped_mm`` with device-side group
    offsets), so their work follows the routed rows, not T rows an expert.
    Under a mesh neither is supported (an error says so).

Telemetry: a ``moe.route`` span (``scoring``, ``tokens``) around the
router and a ``moe.experts`` span (``held``, ``routed_over``) around the
expert layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distribution import sharding
from ..obs import get_telemetry
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
    Switch load-balancing loss E * sum_e f_e * P_e.  The ``noaux_tc``
    router where the config names it (``_route_grouped``)."""
    if _noaux(cfg):
        return _route_grouped(p, xt, cfg)
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


def _noaux(cfg: ArchConfig) -> bool:
    """Whether the config names the ``noaux_tc`` router's scoring or groups."""
    return cfg.scoring_func != "softmax" or cfg.n_group > 1


def _route_grouped(p: Dict[str, Any], xt: torch.Tensor, cfg: ArchConfig):
    """DeepSeek-V3's ``noaux_tc`` router over the router's width R (global
    expert ids), as its reference ``Gate``: (T,D) -> gates (T,k), experts
    (T,k) and the sequence-wise balance loss R * sum_e f_e * P_e over the
    scores normalised per token."""
    logits = xt.float() @ p["router"]  # (T, R)
    scores = torch.sigmoid(logits) if cfg.scoring_func == "sigmoid" else torch.softmax(
        logits, dim=-1)
    choose = scores + p["router_bias"] if "router_bias" in p else scores
    t, r = choose.shape
    if cfg.n_group > 1:
        grouped = choose.reshape(t, cfg.n_group, r // cfg.n_group)
        rank = grouped.topk(2, dim=-1).values.sum(-1)  # (T, G)
        best = torch.topk(rank, cfg.topk_group, dim=-1).indices
        drop = torch.ones_like(rank, dtype=torch.bool).scatter_(1, best, False)
        choose = grouped.masked_fill(drop[..., None], float("-inf")).reshape(t, r)
    eidx = torch.topk(choose, cfg.experts_per_token, dim=-1).indices
    gates = scores.gather(1, eidx)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True)
    if cfg.routed_scaling_factor != 1.0:
        gates = gates * cfg.routed_scaling_factor
    me = (scores / scores.sum(-1, keepdim=True)).mean(0)
    aux = r * torch.sum(me * _expert_share(eidx, me))
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
    held = bool(cfg.n_routed_experts)
    if (held or _noaux(cfg)) and _under_mesh():
        raise ValueError(
            f"{cfg.name}: the held-expert layer (n_routed_experts) and the grouped or "
            "sigmoid router run on one device only; under a mesh use the default router "
            "and dispatch")
    tel = get_telemetry()
    tracer = tel.tracer
    with tracer.span("moe.route") as sp:
        if tel.enabled:
            sp.set(scoring=cfg.scoring_func, tokens=b * s)
        gates, eidx, aux = _route(p, xt, cfg)
    with tracer.span("moe.experts") as sp:
        if tel.enabled:
            sp.set(held=cfg.n_experts, routed_over=cfg.router_width)
        if held:
            y = _apply_held(p, xt, gates, eidx, cfg)
        elif _MOE_IMPL["mode"] == "alltoall":
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


def _under_mesh() -> bool:
    ctx = sharding.current()
    return ctx is not None and not sharding.is_trivial(ctx["mesh"])


def _apply_held(p, xt: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """The held experts' part of the layer (T,D) in xt's dtype: for every
    (token, choice) routed to an expert held here, the expert's SwiGLU of
    the token times the choice's gate; nothing dropped, nothing for the
    other experts.

    The (token, choice) pairs are sorted by held expert (the others last)
    into a buffer of static size, T x min(k, E) rows, which bounds every
    routing.  The grouped GEMMs compute the groups' rows alone; the gate
    scales the SwiGLU's hidden row before the down projection; every
    buffer row that holds no pair (past the last group, where the GEMMs
    leave the output unset) is added to a spare row T that is cut off.
    No step reads a count on the host."""
    t, d = xt.shape
    k, e, lo = cfg.experts_per_token, cfg.n_experts, cfg.expert_offset
    dev = xt.device
    n_buf = t * min(k, e)

    local = eidx.reshape(-1) - lo  # (T*k,) held experts' local ids
    key = torch.where((local >= 0) & (local < e), local, e)  # the others: e
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(e + 1, dtype=torch.long, device=dev).scatter_add_(
        0, key, torch.ones_like(key))
    ends = torch.cumsum(counts[:e], 0).to(torch.int32)  # each group's end in the buffer
    src = order[:n_buf]  # the held pairs first, by expert, then others
    tok = torch.where(key[src] < e, src // k, t)  # row t: zeros in, cut off out

    rows = torch.cat([xt, xt.new_zeros((1, d))])[tok]  # (n_buf, D)
    gate = gates.reshape(-1)[src].to(xt.dtype)
    ex = p["experts"]
    h = F.silu(torch._grouped_mm(rows, ex["w_gate"], offs=ends)) * torch._grouped_mm(
        rows, ex["w_up"], offs=ends)
    out = torch._grouped_mm(h * gate[:, None], ex["w_out"], offs=ends)
    return xt.new_zeros((t + 1, d)).index_add_(0, tok, out)[:t]
