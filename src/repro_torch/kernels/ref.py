"""Plain PyTorch versions of the kernels: naive, obviously-correct math.  They are the CPU execution path and the oracle that every CUDA kernel
is held against on the card.  Counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = [
    "attention_ref", "decode_attention_ref", "decode_split_partials_ref",
    "decode_split_combine_ref", "quantize_kv", "decode_attention_q8_ref", "ssd_scan_ref",
]

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
    the PV product, as in the reference oracle.  A sequence with no valid
    slot (length <= 0) gets zeros, as the kernels give it (the reference
    oracle would average the whole cache there).
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
    out = out * (lim > 0).to(out.dtype)[:, None, None, None, None]
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def decode_split_partials_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    length: Union[int, torch.Tensor],
    split: int,
):
    """The split-K decode's first pass, plainly.  The cache rows are cut
    into NS = ceil(Smax / split) pieces; for piece s, rows
    [s * split, (s + 1) * split) below min(length, Smax), and each query
    head: m = the largest score (-inf for an empty piece), l = sum of
    exp(score - m), acc = sum of exp(score - m) v.  Returns m, l (B, Hq, NS)
    and acc (B, Hq, NS, Dv), in f32."""
    b, _, hq, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    ns = -(-smax // split)
    pad = (0, 0, 0, 0, 0, ns * split - smax)  # zero rows up to NS * split
    kf = torch.nn.functional.pad(k.float(), pad)
    vf = torch.nn.functional.pad(v.float(), pad).reshape(b, ns, split, hkv, dv)
    scores = torch.einsum("bhgd,bkhd->bhgk", q.reshape(b, hkv, g, d).float(), kf) / (d ** 0.5)
    lim = torch.as_tensor(length, device=q.device).clamp(0, smax).expand(b)
    valid = torch.arange(ns * split, device=q.device)[None, :] < lim[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    scores = scores.reshape(b, hkv, g, ns, split)
    m = scores.amax(-1)
    p = torch.exp(scores - m.masked_fill(m == float("-inf"), 0.0)[..., None])
    acc = torch.einsum("bhgsk,bskhd->bhgsd", p, vf)
    return m.reshape(b, hq, ns), p.sum(-1).reshape(b, hq, ns), acc.reshape(b, hq, ns, dv)


def decode_split_combine_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """The split-K decode's second pass: each head's partials weighted by
    exp(m_s - max m), summed, over the weighted sum of l.  An empty piece
    weighs 0; a head with no valid row gets zeros.  -> (B, 1, Hq, Dv)."""
    mt = m.amax(-1, keepdim=True)
    w = torch.exp(m - mt.masked_fill(mt == float("-inf"), 0.0))
    lt = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(-2) / lt.masked_fill(lt == 0, 1.0)[..., None]
    b, hq, _, dv = acc.shape
    return out.reshape(b, 1, hq, dv).to(dtype)


def quantize_kv(k: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of a KV tensor.

    k (B,S,Hkv,D) -> (q int8 (B,S,Hkv,D), scale f32 (B,S,Hkv)).  Rounds half
    to even, as the reference does."""
    kf = k.float()
    scale = kf.abs().amax(-1).clamp(min=1e-8) / 127.0
    q = torch.round(kf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def decode_attention_q8_ref(
    q: torch.Tensor,  # (B,1,Hq,D)
    k_q: torch.Tensor,  # (B,Smax,Hkv,D) int8
    k_s: torch.Tensor,  # (B,Smax,Hkv) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    length: Union[int, torch.Tensor],
) -> torch.Tensor:
    """int8-KV decode: dequantize the whole cache, then the fp decode."""
    k = k_q.float() * k_s[..., None]
    v = v_q.float() * v_s[..., None]
    return decode_attention_ref(q, k, v, length)


def ssd_scan_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
):
    """Mamba-2 SSD as the naive sequential recurrence.

    x (Bt,S,H,P)  dt (Bt,S,H)  A (H,) negative  B,C (Bt,S,N)
    state h (Bt,H,P,N):  h_t = exp(A*dt_t) h_{t-1} + dt_t * x_t B_t^T
                         y_t = h_t C_t
    Returns y (Bt,S,H,P) in x's dtype and the final state in f32.
    """
    bt, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), B.float(), C.float(), A.float()
    state = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(Af[None, :] * dtf[:, t])  # (Bt,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((bt, 0, h, p))
    return y.to(x.dtype), state
