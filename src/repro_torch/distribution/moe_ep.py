"""Expert-parallel MoE over the ``model`` mesh axis.  Counterpart of
``repro/distribution/moe_ep.py``, computed as the reference computes it.

The dispatch implementation (``models/moe.py``) pays two dense
(T x E*C x D) one-hot einsums per MoE layer.  This layer replaces them with
sort + scatter/gather bookkeeping inside a per-rank region over the mesh
(``local_map``, where the reference uses ``shard_map``):

  * tokens enter replicated over ``model`` and sharded over the data axes;
  * each model rank builds capacity-bounded buffers for the experts it owns
    (a stable argsort by expert id, positions by ``searchsorted``; no
    matmul);
  * the rank runs the SwiGLU FFN on its (E_local, C, D) buffer, the only
    dense compute;
  * it scatter-adds the outputs back to their tokens with the gates, and
    one all-reduce over the model group closes the layer (the rank's
    output leaves the region as a partial sum over ``model``).

Despite the name there is no all-to-all exchange, in the reference either.

Expert and mesh shapes:
  * E >= m (the ``model`` size): E/m experts per rank;
  * E < m with m % E == 0: each expert is replicated over rep = m/E ranks,
    its FFN hidden dim F split rep ways (the expert + tensor hybrid); the
    closing all-reduce sums the tensor-parallel partials with the combine.

The layer falls back to dispatch where no mesh with a ``model`` axis is
set, or where neither of E and m divides the other.  On a mesh of one
rank the tensors are plain and the per-rank code runs on them directly.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import sharding

__all__ = ["apply_moe_alltoall"]


def _local_moe(xt, gates, eidx, wg, wu, wo, *, rank: int, e_local: int, rep: int,
               cap: int, k: int) -> torch.Tensor:
    """One rank's expert-parallel MoE: xt (Tl,D) replicated over ``model``;
    wg/wu/wo this rank's expert slices (E_local, D, Fl).  Returns the rank's
    f32 partial output (Tl, D)."""
    t, d = xt.shape
    dev = xt.device
    e_lo = (rank // rep) * e_local  # the first global expert owned here

    # dispatch bookkeeping (sort + positions; no matmuls)
    ef = eidx.reshape(-1)  # (T*k,) global expert ids
    mine = (ef >= e_lo) & (ef < e_lo + e_local)
    key = torch.where(mine, ef - e_lo, torch.full_like(ef, e_local))  # foreign -> sentinel
    order = torch.argsort(key, stable=True)
    se = key[order]  # sorted local-expert ids, the sentinel last
    seg_start = torch.searchsorted(se, torch.arange(e_local + 1, device=dev, dtype=se.dtype))
    pos = torch.arange(t * k, device=dev) - seg_start[se.clamp(0, e_local)]
    keep = (se < e_local) & (pos < cap)
    src_tok = order // k

    # scatter the kept tokens into (E_local, C, D); the rest are dropped
    e_kept, c_kept, tok_kept = se[keep], pos[keep], src_tok[keep]
    buf = xt.new_zeros((e_local, cap, d)).index_put((e_kept, c_kept), xt[tok_kept])

    # the expert FFN, the only dense compute
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    a = F.silu(g.float()).to(u.dtype) * u
    out = torch.einsum("ecf,efd->ecd", a, wo)  # (E_local, C, D)

    # combine: gather back and scatter-add by token, weighted by the gates
    vals = out[e_kept, c_kept].float()
    w = gates.reshape(-1)[order][keep].float()
    return xt.new_zeros((t, d), dtype=torch.float32).index_add(0, tok_kept,
                                                               vals * w[:, None])


def _rank_slice(wg, wu, wo, rank: int, rep: int):
    """The expert + tensor hybrid's slice of rank ``rank``: expert
    rank // rep, the (rank % rep)-th of rep slices of its hidden dim F."""
    e, j = rank // rep, rank % rep
    fs = wg.shape[-1] // rep
    f = slice(j * fs, (j + 1) * fs)
    return wg[e:e + 1, :, f], wu[e:e + 1, :, f], wo[e:e + 1, f, :]


def apply_moe_alltoall(p: Dict[str, Any], xt: torch.Tensor, gates: torch.Tensor,
                       eidx: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """xt (T,D), gates and eidx (T,k) -> (T,D) in xt's dtype."""
    ctx = sharding.current()
    mesh = ctx["mesh"] if ctx is not None else None
    sizes = sharding.mesh_axes(mesh) if mesh is not None else {}
    m = sizes.get("model", 1)
    e, k = cfg.n_experts, cfg.experts_per_token
    if mesh is None or "model" not in sizes or (e % m and m % e):
        # no expert-parallel mesh (or an incompatible expert count)
        from ..models.moe import _apply_dispatch

        return _apply_dispatch(p, xt, gates, eidx, cfg)

    daxes = sharding.data_axes(mesh)
    dp = math.prod(sizes[a] for a in daxes)
    t = xt.shape[0]
    if t % dp:
        dp, daxes = 1, ()  # a batch too small to split: replicate the tokens
    t_local = max(1, t // dp)
    e_local = max(1, e // m)
    rep = max(1, m // e)
    cap = max(4, int(math.ceil(t_local * k / e * cfg.capacity_factor)))
    cap = min(cap, t_local * k)

    wg, wu, wo = (p["experts"][n] for n in ("w_gate", "w_up", "w_out"))
    if not sharding.is_dtensor(xt):
        # a mesh of one rank: the tensors are plain, the region is this rank
        y = _local_moe(xt, gates, eidx, wg, wu, wo, rank=0, e_local=e_local, rep=rep,
                       cap=cap, k=k)
        return y.to(xt.dtype)

    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = xt.device_mesh
    names = mesh.mesh_dim_names
    bax = (daxes if len(daxes) > 1 else daxes[0]) if daxes else None
    tok = sharding.placements((bax, None), mesh)
    # the region takes each rank's experts whole over the data axes, as the
    # reference's shard_map specs do (an fsdp shard is gathered here).  The
    # hybrid's experts are replicated over ``model`` (E < m never shards
    # them) and each rank slices its own part of F in the region.
    wts = sharding.placements((None if rep > 1 else "model", None, None), mesh)
    # gradients: a token's from every model rank's experts add up; a
    # weight's from every data rank's tokens (and, in the hybrid, from
    # every model rank's slice) add up
    tok_grad = tuple(Partial() if a == "model" else pl for a, pl in zip(names, tok))
    wts_grad = tuple(Partial() if a in daxes or (a == "model" and rep > 1) else pl
                     for a, pl in zip(names, wts))
    out = tuple(Partial() if a == "model" else pl for a, pl in zip(names, tok))
    rank = mesh.get_local_rank("model")

    def local(xt, gates, eidx, wg, wu, wo):
        if rep > 1:
            wg, wu, wo = _rank_slice(wg, wu, wo, rank, rep)
        return _local_moe(xt, gates, eidx, wg, wu, wo, rank=rank, e_local=e_local,
                          rep=rep, cap=cap, k=k)

    args = [a.redistribute(mesh, pl) for a, pl in
            zip((xt, gates, eidx, wg, wu, wo), (tok, tok, tok, wts, wts, wts))]
    y = local_map(local, out_placements=list(out), in_placements=(tok,) * 3 + (wts,) * 3,
                  in_grad_placements=(tok_grad, tok_grad, tok, wts_grad, wts_grad, wts_grad),
                  device_mesh=mesh)(*args)
    # the one all-reduce over the model group
    y = y.redistribute(mesh, tuple(Replicate() if a == "model" else pl
                                   for a, pl in zip(names, y.placements)))
    return y.to(xt.dtype)
