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

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
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
    """Depthwise causal conv; x (B,S,C), w (K,C).  Returns (silu(y), new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
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

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])

    if state is not None and s == 1:
        # recurrent decode step
        decay = torch.exp(A[None, :] * dt[:, 0])  # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xin[:, 0].float(), Bm[:, 0].float())
        h_new = state["ssm"] * decay[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", h_new, Cm[:, 0].float())[:, None]
    else:
        init = state["ssm"] if state is not None else None
        y, h_new = kops.ssd_scan(xin, dt, A, Bm, Cm, initial_state=init)
    if state is not None:
        state["ssm"].copy_(h_new)
        state["conv"].copy_(new_conv)

    y = y.to(x.dtype) + xin * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner) * F.silu(z)
    y = layers.apply_norm(p["norm"], y)
    return y @ p["w_out"], state


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    d_inner, h, pdim, n = mamba_dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, pdim, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * n), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix-memory LSTM with a parallel (attention-like) prefill
# ---------------------------------------------------------------------------
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
    q = (up @ p["wq"]).reshape(b, s, h, dh)
    k = (up @ p["wk"]).reshape(b, s, h, dh) / torch.tensor(math.sqrt(dh)).to(x.dtype)
    v = (up @ p["wv"]).reshape(b, s, h, dh)
    gates = up.float() @ p["w_if"].float() + p["if_bias"]
    i_pre, f_pre = gates[..., :h], gates[..., h:]  # (B,S,H)
    logf = F.logsigmoid(f_pre)
    qf, kf, vf = q.float(), k.float(), v.float()

    if state is not None and s == 1:
        C, n, m = state["C"], state["n"], state["m"]
        m_new = torch.maximum(logf[:, 0] + m, i_pre[:, 0])
        i_g = torch.exp(i_pre[:, 0] - m_new)
        f_g = torch.exp(logf[:, 0] + m - m_new)
        q0, k0, v0 = qf[:, 0], kf[:, 0], vf[:, 0]
        C_new = C * f_g[..., None, None] + i_g[..., None, None] * k0[..., :, None] * v0[..., None, :]
        n_new = n * f_g[..., None] + i_g[..., None] * k0
        num = torch.einsum("bhk,bhkv->bhv", q0, C_new)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", q0, n_new).abs(), torch.exp(-m_new))
        y = (num / den[..., None])[:, None]  # (B,1,H,dh)
        C.copy_(C_new)
        n.copy_(n_new)
        m.copy_(m_new)
    else:
        # parallel stabilised form (xLSTM paper eq. 19-27)
        lf_cum = torch.cumsum(logf, dim=1)  # (B,S,H)
        dmat = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + i_pre[:, None, :, :]
        tri = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
        m_row = dmat.amax(dim=2)  # (B,S,H)
        dprime = torch.exp(dmat - m_row[:, :, None, :])
        w = torch.einsum("bqhd,bkhd->bqkh", qf, kf) * dprime
        den = torch.maximum(w.sum(2).abs(), torch.exp(-m_row))  # (B,S,H)
        y = torch.einsum("bqkh,bkhd->bqhd", w, vf) / den[..., None]
        if state is not None:
            # m_T = max_u (i_u + lf_T - lf_u); C_T = sum_u e^{i_u+lf_T-lf_u-m_T} k_u v_u^T
            tailw = i_pre + lf_cum[:, -1:, :] - lf_cum  # (B,S,H)
            m_T = tailw.amax(dim=1)  # (B,H)
            wgt = torch.exp(tailw - m_T[:, None, :])
            state["C"].copy_(torch.einsum("bsh,bshk,bshv->bhkv", wgt, kf, vf))
            state["n"].copy_(torch.einsum("bsh,bshk->bhk", wgt, kf))
            state["m"].copy_(m_T)

    y = y.to(x.dtype).reshape(b, s, 2 * d)
    y = layers.apply_norm(p["norm"], y) * z
    return y @ p["w_down"], state


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
    time is a Python loop over S here."""
    b, s, d = x.shape
    wx = (x @ p["w_gates"]).float()  # (B,S,4D)
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    c, n, hprev, m = st["c"], st["n"], st["h"], st["m"]
    rw = p["r_gates"].float()
    gb = p["g_bias"]
    hs = []
    for t in range(s):
        g = wx[:, t] + hprev @ rw + gb
        ig, fg, zg, og = g.chunk(4, dim=-1)
        logf = F.logsigmoid(fg)
        m_new = torch.maximum(logf + m, ig)
        i = torch.exp(ig - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(zg)
        n = f * n + i
        hprev = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hprev)
    if state is not None:
        for key, val in (("c", c), ("n", n), ("h", hprev), ("m", m)):
            state[key].copy_(val)
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,D)
    y = layers.apply_norm(p["norm"], y)
    y = y + layers.apply_mlp(p["w_ff"], y, "swiglu")
    return y, state


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    shape, f32 = (batch, cfg.d_model), torch.float32
    return {
        "c": torch.zeros(shape, dtype=f32, device=device),
        "n": torch.ones(shape, dtype=f32, device=device),
        "h": torch.zeros(shape, dtype=f32, device=device),
        "m": torch.zeros(shape, dtype=f32, device=device),
    }
