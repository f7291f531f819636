"""Recurrent blocks: Mamba-2 (SSD) and xLSTM's mLSTM and sLSTM.
Counterpart of ``repro/models/ssm.py``.

Mamba-2's prefill form runs the chunked SSD scan (``kernels.ops.ssd_scan``:
the hand-written kernel for a CUDA tensor); its one-token decode step is the
O(1)-state recurrence in plain torch, as in the reference.  The xLSTM blocks
run no kernel of their own in either package: plain tensor code, with the
reference's dtype points (``k / sqrt(dh)`` in the model dtype, gates,
states and the mixer's q/k/v products in f32).  Each block's state doubles
as its "KV cache".  Where the reference returns a new state, a block here
writes it into the given tensors in place (they are views of the model's
stacked cache) and returns them.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distribution import sharding
from ..kernels import ops as kops
from . import layers

Params = Dict[str, Any]
CONV_K = 4  # mamba short-conv width


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state size N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or max(1, d_inner // 64)
    return d_inner, heads, d_inner // heads, cfg.ssm_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv; x (B,S,C), w (K,C).  Returns (silu(y), new_state).
    On DTensors it runs per rank with the batch over the data axes and the
    channels whole (``sharding.per_rank``): torch 2.11's DTensor fails on
    the pad of a DTensor that requires grad."""
    if sharding.is_dtensor(x):
        bax, _ = sharding.local_layout(x)
        rows = (bax, None, None)
        return tuple(sharding.per_rank(_causal_conv, (x, w, state), [rows, (None, None), rows],
                                       [rows, rows]))
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    return F.silu(y), xp[:, -(k - 1):]


def mamba2_block(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B,S,D).  state = {"ssm" (B,H,P,N) f32, "conv" (B,K-1,convdim)} or None;
    a given state is advanced in place and returned."""
    b, s, _ = x.shape
    d_inner, h, pdim, n = mamba_dims(cfg)
    z_xbc_dt = x @ p["w_in"]
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner: 2 * d_inner + 2 * n]
    dt_raw = z_xbc_dt[..., -h:]

    xbc, new_conv = _causal_conv(xbc, p["conv_w"], state["conv"] if state is not None else None)
    # views of the conv output: the scan reads them through their strides
    xin = xbc[..., :d_inner].reshape(b, s, h, pdim)
    Bm = xbc[..., d_inner: d_inner + n]
    Cm = xbc[..., d_inner + n:]

    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])

    if state is not None and s == 1:
        y, h_new = _mamba2_step(dt, xin, Bm, Cm, A, state["ssm"])
    else:
        init = state["ssm"] if state is not None else None
        y, h_new = kops.ssd_scan(xin, dt, A, Bm, Cm, initial_state=init)
    if state is not None:
        state["ssm"].copy_(h_new)
        state["conv"].copy_(new_conv)

    y = y.to(x.dtype) + xin * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner) * F.silu(z)
    y = layers.apply_norm(p["norm"], y)
    # the row-parallel product's partial sums are reduced here, as
    # layers.apply_mlp reduces its own
    return layers.hint(y @ p["w_out"], "batch", "seq", None), state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus``; on a DTensor, the same function from pointwise ops
    (DTensor has no sharding rule for ``softplus`` or ``softplus_backward``,
    which it reaches only through its decomposition fallback)."""
    if sharding.is_dtensor(x):
        return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return F.softplus(x)


def _ssd_step(dt, xin, Bm, Cm, A, h):
    """One token of the SSD recurrence: dt (B,1,H), xin (B,1,H,P), Bm and Cm
    (B,1,N), A (H,), h (B,H,P,N) f32 -> y (B,1,H,P), the new state."""
    decay = torch.exp(A[None, :] * dt[:, 0])  # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xin[:, 0].float(), Bm[:, 0].float())
    h_new = h * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm[:, 0].float())[:, None]
    return y, h_new


def _mamba2_step(dt, xin, Bm, Cm, A, h):
    """``_ssd_step``; on DTensors per rank (``sharding.per_rank``)
    with the batch over the data axes and the heads over ``model``: torch
    2.11's DTensor refuses the einsums' flattening of a sharded head dim."""
    if not sharding.is_dtensor(xin):
        return _ssd_step(dt, xin, Bm, Cm, A, h)
    bax, hax = sharding.local_layout(xin, xin.shape[2])
    specs = [(bax, None, hax), (bax, None, hax, None), (bax, None, None), (bax, None, None),
             (hax,), (bax, hax, None, None)]
    return sharding.per_rank(_ssd_step, (dt, xin, Bm, Cm, A, h), specs,
                             [specs[1], specs[-1]])


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    d_inner, h, pdim, n = mamba_dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, pdim, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * n), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix-memory LSTM with a parallel (attention-like) prefill
# ---------------------------------------------------------------------------
def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor, whose ``log_sigmoid_backward`` DTensor
    has no sharding rule for, the same function from pointwise ops."""
    if sharding.is_dtensor(x):
        return torch.clamp(x, max=0) - torch.log1p(torch.exp(-x.abs()))
    return F.logsigmoid(x)


def mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    """(heads H, head dim dh): the block up-projects d to 2d and splits it."""
    return cfg.n_heads, 2 * cfg.d_model // cfg.n_heads


def mlstm_block(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B,S,D).  state = {"C" (B,H,dh,dh), "n" (B,H,dh), "m" (B,H)} f32 or
    None.  One token against a state is the recurrent step; anything else is
    the parallel stabilised form, which derives the final state in closed
    form (from a zero state, as the reference does) when a state is given."""
    b, s, d = x.shape
    h, dh = mlstm_dims(cfg)
    up = x @ p["w_up"]
    z = F.silu(x @ p["w_z"])
    q = layers.split_heads(up @ p["wq"], h, dh)
    k = layers.split_heads(up @ p["wk"], h, dh) / torch.tensor(math.sqrt(dh)).to(x.dtype)
    v = layers.split_heads(up @ p["wv"], h, dh)
    gates = up.float() @ p["w_if"].float() + p["if_bias"]
    i_pre, f_pre = gates[..., :h], gates[..., h:]  # (B,S,H)
    logf = _logsigmoid(f_pre)
    y = _mlstm_mix(q.float(), k.float(), v.float(), i_pre, logf, state)
    y = sharding.merge_heads(y.to(x.dtype))
    y = layers.apply_norm(p["norm"], y) * z
    return layers.hint(y @ p["w_down"], "batch", "seq", None), state


def _mlstm_core(qf, kf, vf, i_pre, logf, C=None, n=None, m=None, final_state=False):
    """The mLSTM's mixing on f32 q, k, v (B,S,H,dh) and gates (B,S,H):
    given a state (C, n, m), the recurrent step of one token; else the
    parallel stabilised form, with the final state in closed form when
    ``final_state``.  Returns (y,) or (y, C, n, m)."""
    s = qf.shape[1]
    if C is not None:
        m_new = torch.maximum(logf[:, 0] + m, i_pre[:, 0])
        i_g = torch.exp(i_pre[:, 0] - m_new)
        f_g = torch.exp(logf[:, 0] + m - m_new)
        q0, k0, v0 = qf[:, 0], kf[:, 0], vf[:, 0]
        C_new = C * f_g[..., None, None] + i_g[..., None, None] * k0[..., :, None] * v0[..., None, :]
        n_new = n * f_g[..., None] + i_g[..., None] * k0
        num = torch.einsum("bhk,bhkv->bhv", q0, C_new)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", q0, n_new).abs(), torch.exp(-m_new))
        return (num / den[..., None])[:, None], C_new, n_new, m_new  # y (B,1,H,dh)
    # parallel stabilised form (xLSTM paper eq. 19-27)
    lf_cum = torch.cumsum(logf, dim=1)  # (B,S,H)
    dmat = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + i_pre[:, None, :, :]
    tri = torch.ones((s, s), dtype=torch.bool, device=qf.device).tril()
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    m_row = dmat.amax(dim=2)  # (B,S,H)
    dprime = torch.exp(dmat - m_row[:, :, None, :])
    w = torch.einsum("bqhd,bkhd->bqkh", qf, kf) * dprime
    den = torch.maximum(w.sum(2).abs(), torch.exp(-m_row))  # (B,S,H)
    y = torch.einsum("bqkh,bkhd->bqhd", w.contiguous(), vf.contiguous()) / den[..., None]
    if not final_state:
        return (y,)
    # m_T = max_u (i_u + lf_T - lf_u); C_T = sum_u e^{i_u+lf_T-lf_u-m_T} k_u v_u^T
    tailw = i_pre + lf_cum[:, -1:, :] - lf_cum  # (B,S,H)
    m_T = tailw.amax(dim=1)  # (B,H)
    wgt = torch.exp(tailw - m_T[:, None, :])
    return (y, torch.einsum("bsh,bshk,bshv->bhkv", wgt, kf, vf),
            torch.einsum("bsh,bshk->bhk", wgt, kf), m_T)


def _mlstm_mix(qf, kf, vf, i_pre, logf, state):
    """``_mlstm_core`` with ``state`` advanced in place; y (B,S,H,dh) f32.
    On DTensors it runs per rank (``sharding.per_rank``), batch over the
    data axes and heads over ``model``: torch 2.11's DTensor refuses the
    einsums' flattening of a sharded head dim."""
    step = state is not None and qf.shape[1] == 1
    carried = (state["C"], state["n"], state["m"]) if step else (None, None, None)
    fn = functools.partial(_mlstm_core, final_state=state is not None)
    if sharding.is_dtensor(qf):
        bax, hax = sharding.local_layout(qf, qf.shape[2])
        heads, gate = (bax, None, hax, None), (bax, None, hax)
        specs = [heads] * 3 + [gate] * 2 + [(bax, hax, None, None), (bax, hax, None), (bax, hax)]
        outs = [heads] + (specs[5:] if state is not None else [])
        out = tuple(sharding.per_rank(fn, (qf, kf, vf, i_pre, logf, *carried), specs, outs))
    else:
        out = fn(qf, kf, vf, i_pre, logf, *carried)
    if state is not None:
        for key, val in zip(("C", "n", "m"), out[1:]):
            state[key].copy_(val)
    return out[0]


def init_mlstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    h, dh = mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
        "m": torch.zeros((batch, h), dtype=f32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar-memory recurrent LSTM with exponential gating
# ---------------------------------------------------------------------------
def slstm_ff_width(cfg: ArchConfig) -> int:
    return int(cfg.d_model * 4 / 3)


def slstm_block(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B,S,D).  state = {"c", "n", "h", "m"} each (B,D) f32, or None (a
    fresh state: ``n`` starts at ones).  The reference's ``lax.scan`` over
    time is a Python loop over S here; on DTensors the whole loop runs per
    rank (``_slstm_scan``)."""
    wx = (x @ p["w_gates"]).float()  # (B,S,4D)
    carried = tuple(state[k] for k in _SLSTM_STATE) if state is not None else (None,) * 4
    hs, *new = _slstm_scan(wx, p["r_gates"].float(), p["g_bias"], *carried)
    if state is not None:
        for key, val in zip(_SLSTM_STATE, new):
            state[key].copy_(val)
    y = hs.to(x.dtype)  # (B,S,D)
    y = layers.apply_norm(p["norm"], y)
    y = y + layers.apply_mlp(p["w_ff"], y, "swiglu")
    return y, state


_SLSTM_STATE = ("c", "n", "h", "m")


def _slstm_loop(wx, rw, gb, c, n, hprev, m):
    """The sLSTM's time loop over wx (B,S,4D) from the state (c, n, h, m),
    each (B,D) f32 (None: a fresh state).  Returns (h over time (B,S,D), c,
    n, h, m)."""
    if c is None:
        c, n, hprev, m = _fresh_slstm_state(wx.shape[0], wx.shape[-1] // 4, wx.device)
    hs = []
    for t in range(wx.shape[1]):
        g = wx[:, t] + hprev @ rw + gb
        ig, fg, zg, og = g.chunk(4, dim=-1)
        logf = _logsigmoid(fg)
        m_new = torch.maximum(logf + m, ig)
        i = torch.exp(ig - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(zg)
        n = f * n + i
        hprev = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, dim=1), c, n, hprev, m


def _slstm_scan(wx, rw, gb, c, n, hprev, m):
    """``_slstm_loop``; on DTensors in one region per rank
    (``sharding.per_rank``): ``wx`` and the recurrent weights are gathered
    over ``model`` once, the batch stays on its data axes, and the loop runs
    on each rank's plain blocks, so no step dispatches an op on a DTensor."""
    if not sharding.is_dtensor(wx):
        return _slstm_loop(wx, rw, gb, c, n, hprev, m)
    bax, _ = sharding.local_layout(wx)
    row = (bax, None)
    specs = [(bax, None, None), (None, None), (None,)] + [row] * 4
    return tuple(sharding.per_rank(_slstm_loop, (wx, rw, gb, c, n, hprev, m), specs,
                                   [(bax, None, None)] + [row] * 4))


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    return dict(zip(_SLSTM_STATE, _fresh_slstm_state(batch, cfg.d_model, device)))


def _fresh_slstm_state(batch: int, d: int, device):
    """(c, n, h, m), each (batch, d) f32: zeros, but ``n`` at ones."""
    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return zeros(), torch.ones((batch, d), dtype=torch.float32, device=device), zeros(), zeros()
