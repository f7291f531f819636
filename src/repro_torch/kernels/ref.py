"""Plain PyTorch versions of the attention kernels: naive, obviously-correct
math.  They are the CPU execution path and the oracle that every CUDA kernel
is held against on the card.  Counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["attention_ref", "decode_attention_ref"]

_NEG = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """q (B,Sq,Hq,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv) -> (B,Sq,Hq,Dv).

    GQA by head grouping (query head h reads KV head h // (Hq/Hkv)); the
    causal mask aligns the ends of the query and key ranges, so query row i
    sits at key position i + (Sk - Sq).  Materializes the full score matrix.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (d ** 0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    length: Union[int, torch.Tensor],
) -> torch.Tensor:
    """One-token decode: q (B,1,Hq,D) against a cache k/v (B,Smax,Hkv,D).

    Valid cache slots are ``arange(Smax) < min(length, Smax)``; ``length`` is
    a scalar (uniform batch) or a (B,) tensor (ragged continuous batching).
    Scores accumulate in f32; the probabilities are cast to v's dtype before
    the PV product, as in the reference oracle.
    """
    b, sq, hq, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (d ** 0.5)
    lim = torch.as_tensor(length, device=q.device).clamp(max=smax).expand(b)
    valid = torch.arange(smax, device=q.device)[None, :] < lim[:, None]  # (B, Smax)
    scores = torch.where(
        valid[:, None, None, None, :], scores, torch.full_like(scores, _NEG)
    )
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, dv).to(q.dtype)
