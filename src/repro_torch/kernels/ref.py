"""Plain PyTorch versions of the kernels: naive, obviously-correct math.  They are the CPU execution path and the oracle that every CUDA kernel
is held against on the card.  Counterpart of ``repro/kernels/ref.py``.

The backward passes of flash attention and the SSD scan are here too
(``attention_bwd_ref``, ``ssd_scan_bwd_ref``): the reference has no backward
kernel, so on the card the kernels' autograd Functions differentiate these
plain recomputes."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = [
    "attention_ref", "decode_attention_ref", "decode_split_partials_ref",
    "decode_split_combine_ref", "quantize_kv", "decode_attention_q8_ref",
    "decode_q8_split_partials_ref", "ssd_scan_ref", "ssd_chunk_states_ref",
    "ssd_state_passing_ref", "ssd_chunk_scan_ref", "attention_bwd_ref", "ssd_scan_chunked_ref",
    "ssd_scan_bwd_ref",
]

_NEG = -1e30


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: f32 for bf16 and f32, f64 kept."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _attention_mask(sq: int, sk: int, causal: bool, sliding_window: Optional[int], device,
                    q0: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """(rows, Sk) bool: query rows q0 .. q0 + rows of Sq against every key,
    the ends of the two ranges aligned (query i sits at key position
    i + Sk - Sq), then causal and the sliding window."""
    rows = sq if rows is None else rows
    qpos = torch.arange(q0, q0 + rows, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((rows, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    return mask


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
    qg = _acc(q.reshape(b, sq, hkv, g, d))
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, _acc(k)) / (d ** 0.5)
    mask = _attention_mask(sq, sk, causal, sliding_window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, _acc(v))
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    q_chunk: int = 512,
):
    """The gradients (dq, dk, dv) of ``attention_ref`` at dout (B,Sq,Hq,Dv),
    each in its input's dtype, recomputed query chunk by query chunk as the
    reference's ``_chunked_attention`` is differentiated: per chunk of
    ``q_chunk`` rows the scores and probabilities (B,Hkv,G,chunk,Sk) are
    rebuilt, never the whole (Sq x Sk) matrix.  The mask is the forward's
    (ends aligned, causal, window); a masked score gets no gradient, as
    through ``attention_ref``'s ``where``.  Accumulates in f32 (f64 for f64
    inputs).  With P the probabilities and dP = dout V^T:
    dV = P^T dout, dS = P (dP - rowsum(P dP)), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv_ = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    kf, vf = _acc(k), _acc(v)
    qg = q.reshape(b, sq, hkv, g, d)
    dog = dout.reshape(b, sq, hkv, g, dv_)
    dq = torch.empty((b, sq, hkv, g, d), dtype=kf.dtype, device=q.device)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, sq, q_chunk):
        rows = min(q_chunk, sq - q0)
        qc, doc = _acc(qg[:, q0:q0 + rows]), _acc(dog[:, q0:q0 + rows])
        mask = _attention_mask(sq, sk, causal, sliding_window, q.device, q0, rows)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf) * scale
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        ds = torch.where(mask, ds, torch.zeros_like(ds))
        dq[:, q0:q0 + rows] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _split_partials(scores: torch.Tensor, v: torch.Tensor, length, split: int,
                    v_scale: Optional[torch.Tensor] = None):
    """scores (B, Hkv, G, Smax) f32 and v (B, Smax, Hkv, Dv) -> the pieces'
    m, l (B, Hq, NS) and acc (B, Hq, NS, Dv); each probability is weighed by
    v_scale (B, Smax, Hkv) in acc where given."""
    b, hkv, g, smax = scores.shape
    dv = v.shape[-1]
    ns = -(-smax // split)
    rows = ns * split - smax  # zero rows up to NS * split
    lim = torch.as_tensor(length, device=scores.device).clamp(0, smax).expand(b)
    valid = torch.arange(ns * split, device=scores.device)[None, :] < lim[:, None]
    scores = torch.nn.functional.pad(scores, (0, rows))
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    scores = scores.reshape(b, hkv, g, ns, split)
    m = scores.amax(-1)
    p = torch.exp(scores - m.masked_fill(m == float("-inf"), 0.0)[..., None])
    pv = p
    if v_scale is not None:
        vs = torch.nn.functional.pad(v_scale.float(), (0, 0, 0, rows)).transpose(1, 2)
        pv = p * vs.reshape(b, hkv, 1, ns, split)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, rows)).reshape(b, ns, split, hkv, dv)
    acc = torch.einsum("bhgsk,bskhd->bhgsd", pv, vf)
    hq = hkv * g
    return m.reshape(b, hq, ns), p.sum(-1).reshape(b, hq, ns), acc.reshape(b, hq, ns, dv)


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
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / (d ** 0.5)
    return _split_partials(scores, v, length, split)


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


def decode_q8_split_partials_ref(
    q: torch.Tensor,  # (B,1,Hq,D)
    k_q: torch.Tensor,  # (B,Smax,Hkv,D) int8
    k_s: torch.Tensor,  # (B,Smax,Hkv) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    length: Union[int, torch.Tensor],
    split: int,
):
    """The split-K int8 decode's first pass, plainly, with the scales folded
    in as the kernel folds them: score = (q . k_q) k_s / sqrt(D), and each
    probability times v_s weighs v_q in the accumulator while l sums the
    probabilities unscaled.  Pieces as in ``decode_split_partials_ref``;
    returns m, l (B, Hq, NS) and acc (B, Hq, NS, Dv) in f32, for
    ``decode_split_combine_ref``."""
    b, _, hq, d = q.shape
    hkv = k_q.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    dots = torch.einsum("bhgd,bkhd->bhgk", qg, k_q.float())
    scores = dots * k_s.float().transpose(1, 2)[:, :, None, :] / (d ** 0.5)
    return _split_partials(scores, v_q, length, split, v_scale=v_s)


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


# ---------------------------------------------------------------------------
# The SSD scan's three chunk-parallel passes, plainly (the tensor-core body's
# structure).  A ragged last chunk is padded with dt = 0 and zero x, B, C: its
# padded steps neither decay the state nor add to it.
# ---------------------------------------------------------------------------
def _ssd_chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(Bt, S, ...) -> f32 (Bt, n_chunks, chunk, ...), zero-padded."""
    s = t.shape[1]
    nc = -(-s // chunk)
    pad = [0, 0] * (t.dim() - 2) + [0, nc * chunk - s]
    return torch.nn.functional.pad(t.float(), pad).reshape(t.shape[0], nc, chunk, *t.shape[2:])


def _ssd_cum(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> torch.Tensor:
    """Inclusive cumsum of A dt within each chunk: (Bt, n_chunks, chunk, H)."""
    return torch.cumsum(_ssd_chunks(dt, chunk) * A.float(), dim=2)


def ssd_chunk_states_ref(x, dt, A, B, chunk: int = 64):
    """Pass 1: each chunk's own contribution to the state, from a zero
    state: S_c = sum_u exp(cum_last - cum_u) dt_u x_u B_u^T, and the chunk's
    total log-decay cum_last.  -> (S (Bt, n_chunks, H, P, N), cum_last
    (Bt, n_chunks, H)), both f32."""
    cum = _ssd_cum(dt, A, chunk)
    cum_last = cum[:, :, -1]
    tail = torch.exp(cum_last[:, :, None] - cum) * _ssd_chunks(dt, chunk)
    states = torch.einsum("bcuh,bcuhp,bcun->bchpn", tail, _ssd_chunks(x, chunk),
                          _ssd_chunks(B, chunk))
    return states, cum_last


def ssd_state_passing_ref(states, cum_last, initial_state=None):
    """Pass 2: the state entering each chunk, h <- h exp(cum_last_c) + S_c
    from the initial state (or zeros).  -> (h_enter (Bt, n_chunks, H, P, N),
    final state (Bt, H, P, N)), both f32."""
    bt, nc, h, p, n = states.shape
    state = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=states.device)
             if initial_state is None else initial_state.float())
    enters = []
    for c in range(nc):
        enters.append(state)
        state = state * torch.exp(cum_last[:, c])[:, :, None, None] + states[:, c]
    h_enter = torch.stack(enters, 1) if enters else states.new_zeros(states.shape)
    return h_enter, state


def ssd_chunk_scan_ref(x, dt, A, B, C, h_enter, chunk: int = 64):
    """Pass 3: each chunk's output from its own inputs and the state entering
    it: y_t = sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
    + exp(cum_t) C_t h_enter^T.  -> y (Bt, S, H, P) in x's dtype."""
    bt, s, h, p = x.shape
    cum = _ssd_cum(dt, A, chunk)  # (Bt, nc, L, H)
    Cc = _ssd_chunks(C, chunk)
    cb = torch.einsum("bctn,bcun->bctu", Cc, _ssd_chunks(B, chunk))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (Bt, nc, t, u, H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))  # exp only for u <= t
    w = cb[..., None] * torch.exp(seg) * _ssd_chunks(dt, chunk)[:, :, None, :, :]
    y = torch.einsum("bctuh,bcuhp->bcthp", w, _ssd_chunks(x, chunk))
    y = y + torch.einsum("bctn,bchpn->bcthp", Cc, h_enter) * torch.exp(cum)[..., None]
    return y.reshape(bt, -1, h, p)[:, :s].to(x.dtype)


def ssd_scan_chunked_ref(x, dt, A, B, C, initial_state=None, chunk: int = 64):
    """``ssd_scan_ref``'s recurrence through the three chunk-parallel passes
    above -> (y (Bt, S, H, P) in x's dtype, final state (Bt, H, P, N) f32).
    The same math in O(S / chunk) steps instead of O(S); differentiable."""
    states, cum_last = ssd_chunk_states_ref(x, dt, A, B, chunk)
    h_enter, final = ssd_state_passing_ref(states, cum_last, initial_state)
    return ssd_chunk_scan_ref(x, dt, A, B, C, h_enter, chunk), final


def ssd_scan_bwd_ref(x, dt, A, B, C, initial_state, dy, dfinal, needs=(True,) * 6):
    """The gradients of the SSD scan for (x, dt, A, B, C, initial_state) at
    dy (Bt,S,H,P) and dfinal (Bt,H,P,N): ``ssd_scan_chunked_ref`` recomputed
    under autograd from f32 copies of the inputs (strided views included)
    and differentiated; each gradient is summed in f32 and rounded to its
    input's dtype once.  ``needs[i]`` False (or a None input) gives None for
    that input."""
    inputs = (x, dt, A, B, C, initial_state)
    leaves = [None if t is None else _acc(t.detach()).requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        y, final = ssd_scan_chunked_ref(*leaves)
        grads = torch.autograd.grad((y, final), wanted, (_acc(dy), _acc(dfinal)),
                                    allow_unused=True)
    it = iter(grads)
    out = []
    for t, leaf in zip(inputs, leaves):
        if leaf is None or not leaf.requires_grad:
            out.append(None)
            continue
        gr = next(it)
        out.append(torch.zeros_like(t) if gr is None else gr.to(t.dtype))
    return tuple(out)
