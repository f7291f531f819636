"""Recurrent blocks: Mamba-2 (SSD).  Counterpart of ``repro/models/ssm.py``
(the xLSTM blocks there are not ported yet).

The prefill form runs the chunked SSD scan (``kernels.ops.ssd_scan``: the
hand-written kernel for a CUDA tensor); the one-token decode step is the
O(1)-state recurrence in plain torch, as in the reference.  The state
``{"ssm", "conv"}`` doubles as the block's "KV cache".  Where the reference
returns a new state, ``mamba2_block`` writes it into the given tensors in
place (they are views of the model's stacked cache) and returns them.
"""
from __future__ import annotations

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
