"""Layers of the dense decoder: norms, RoPE, GQA attention, MLPs, embedding
and the LM head.  Counterpart of ``repro/models/layers.py``.

Plain functions on tensors.  Parameters are dicts of tensors in the
reference layout: weights are ``(d_in, d_out)`` and applied as ``x @ W``;
caches are ``(B, Smax, Hkv, D)``.  Attention routes through
``kernels.ops``, so a CUDA tensor runs the hand-written kernels and a CPU
tensor the plain versions.  Norms and logits are computed in f32.

``set_kv_quant(True)`` makes caches built afterwards hold int8 K/V with an
f32 scale per (token, head), as the reference's switch of the same name.

``hint`` marks activations with logical axes where the reference does.
Under a mesh it redistributes a ``DTensor`` to the placements the sharding
rules give; on a plain tensor, or outside a mesh, it returns its input, so
the forward outside a mesh is unchanged.
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
from ..kernels.ref import quantize_kv
from ..obs import get_telemetry

Params = Dict[str, Any]
_NEG = -1e30  # the reference's mask value

#: int8 KV-cache quantization, read when a cache is built (non-ring GQA caches)
_KV_QUANT = {"enabled": False}


# ---------------------------------------------------------------------------
# sharding hints (no-ops outside a mesh; see distribution.sharding)
# ---------------------------------------------------------------------------
def hint(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    return sharding.constrain(x, logical_axes)


def set_kv_quant(enabled: bool) -> None:
    _KV_QUANT["enabled"] = bool(enabled)


def kv_quant_enabled() -> bool:
    return _KV_QUANT["enabled"]


def apply_norm(p: Params, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-5):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE: interleaved (even, odd) pairs, as in the reference -- not the
# rotate-half convention of Llama/HF checkpoints.
# ---------------------------------------------------------------------------
def rope_tables(
    positions: torch.Tensor, dim: int, theta: float, cfg: Optional[ArchConfig] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> (..., S, dim/2) sin/cos tables in f32.  Given a
    ``cfg`` with ``yarn_factor`` set, the frequencies are YaRN's blend
    (``yarn_inv_freq``) and the tables carry its mscale ratio."""
    half = dim // 2
    if cfg is not None and cfg.yarn_factor:
        freqs = yarn_inv_freq(dim, theta, cfg, positions.device)
        m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / yarn_mscale(
            cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    else:
        exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
        freqs = 1.0 / (theta ** exps)
        m = 1.0
    ang = positions[..., None].float() * freqs
    if m == 1.0:
        return torch.sin(ang), torch.cos(ang)
    return torch.sin(ang) * m, torch.cos(ang) * m


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature factor 0.1 mscale ln(factor) + 1 (1 at
    a factor of 1 or less)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


@functools.lru_cache(maxsize=16)
def yarn_inv_freq(dim: int, theta: float, cfg: ArchConfig, device: torch.device) -> torch.Tensor:
    """YaRN's inverse frequencies (dim/2,) f32 on ``device``: the plain ones
    for the fast dimensions (more than ``yarn_beta_fast`` turns over the
    original length), divided by ``yarn_factor`` for the slow ones (fewer
    than ``yarn_beta_slow``), a linear ramp between (DeepSeek-V3's
    ``yarn_find_correction_range`` and ``yarn_linear_ramp_mask``).  Made
    once a device: the copy to a card waits for its queue."""
    half = dim // 2
    base = theta ** (torch.arange(0, half, dtype=torch.float32) / half)
    extra, inter = 1.0 / base, 1.0 / (cfg.yarn_factor * base)

    def corr(turns: float) -> float:
        return dim * math.log(cfg.yarn_original_len / (turns * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(corr(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the plain frequency, 0: the interpolated one
    return (inter * (1 - keep) + extra * keep).to(device)


def mla_score_gain(cfg: ArchConfig) -> float:
    """What MLA's scores are multiplied by past 1/sqrt(nope + rope): YaRN's
    mscale squared where ``yarn_factor`` and ``yarn_mscale_all_dim`` are
    set, else 1."""
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        return yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return 1.0


def apply_rope(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, mode: str = "full"
) -> torch.Tensor:
    """x (B,S,H,D); rotate pairs (even, odd).  mode='half' rotates only the
    first half of D (ChatGLM-style partial rotary)."""
    if mode == "none":
        return x
    d = x.shape[-1]
    rot_d = d if mode == "full" else d // 2
    xr, xp = x[..., :rot_d], x[..., rot_d:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    s = sin[:, :, None, : rot_d // 2]
    c = cos[:, :, None, : rot_d // 2]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if mode == "half" else yr


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------
def write_rows(dst: torch.Tensor, start: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, start:start + S] = src`` in place (dim 1, ``src`` (B, S, ...)),
    with no host sync on ``start``.

    A DTensor ``dst`` is written by each rank into its own block with local
    ops (DTensor has no rule for ``index_copy_`` in torch 2.11, and in 2.13
    its rule along a sharded dim writes global positions into the local
    block and marks the view replicated).  Where ``dst`` is sharded along
    dim 1 (``cache_specs`` puts a mesh axis on a cache's sequence), every
    row of the rank's block takes ``src``'s row where the written range
    covers it and keeps its own elsewhere, as GSPMD partitions a
    dynamic-update-slice along a sharded dim."""
    s = src.shape[1]
    if not sharding.is_dtensor(dst):
        pos = start.long() + torch.arange(s, device=dst.device)
        dst.index_copy_(1, pos, src.to(dst.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = dst.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in dst.placements)
    src_l = src.redistribute(mesh, pl).to_local().to(dst.dtype)
    start_l = (start.full_tensor() if sharding.is_dtensor(start) else start).long()
    dst_l = dst.to_local()
    if pl == tuple(dst.placements):  # dim 1 whole on every rank
        dst_l.index_copy_(1, start_l + torch.arange(s, device=dst_l.device), src_l)
        return
    _, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    blk = dst_l.shape[1]
    u = offset[1] + torch.arange(blk, device=dst_l.device) - start_l  # src row
    covered = ((u >= 0) & (u < s)).reshape((1, blk) + (1,) * (dst_l.dim() - 2))
    dst_l.copy_(torch.where(covered, src_l.index_select(1, u.clamp(0, s - 1)), dst_l))


def roll_seq(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=1)``; a DTensor takes the same rows
    through slices and a concatenation (torch 2.11's DTensor has no rule
    for ``roll``)."""
    if not sharding.is_dtensor(x):
        return torch.roll(x, shift, dims=1)
    n = x.shape[1]
    k = shift % n
    return torch.cat([x[:, n - k:], x[:, :n - k]], dim=1) if k else x


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(B,S,H*hd) -> (B,S,H,hd).  A DTensor whose last dim is sharded over
    more ranks than there are heads is replicated there first: DTensor does
    not split a shard across a reshape, where GSPMD would."""
    b, s, _ = x.shape
    if sharding.splits_heads(x, n_heads):
        x = hint(x, "batch", "seq", None)
    return x.reshape(b, s, n_heads, hd)


def attention(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
) -> torch.Tensor:
    """GQA self-attention.

    cache: None (no cache) or {"k","v" (B,Smax,Hkv,Dh), "index"} views into
    the model's stacked cache, plus {"k_s","v_s" (B,Smax,Hkv) f32} when k/v
    are int8 (``set_kv_quant``).  ``index`` is a scalar (uniform batch) or a
    (B,) tensor (ragged continuous batching).  Where the reference returns a
    new cache, this updates the given tensors in place: the new K/V rows are
    written (quantized for an int8 cache) and ``index`` advances by the
    number of tokens.

    A sliding-window cache of exactly ``cfg.sliding_window`` rows is a ring:
    decode writes at ``index % Smax`` and attends to every row once the ring
    has wrapped (the decode kernel clamps the length to Smax).  A prefill of
    ``s >= Smax`` tokens stores the last Smax rows of the block, rolled by
    ``s % Smax``, as the reference does -- padding included, so a prompt
    right-padded past the window loses real rows to the padding.
    """
    hd = cfg.head_dim_
    b, s, _ = x.shape
    q = split_heads(x @ p["wq"], cfg.n_heads, hd)
    q = hint(q, "batch", "seq", "heads", None)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
    sin, cos = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos, cfg.rope_mode)
    k = apply_rope(k, sin, cos, cfg.rope_mode)

    if cache is None:
        out = kops.flash_attention(q, k, v, causal=True, sliding_window=cfg.sliding_window)
    else:
        idx = cache["index"]
        quant = "k_s" in cache
        if quant:
            (k_w, ks_w), (v_w, vs_w) = quantize_kv(k), quantize_kv(v)
            rows = ((cache["k"], k_w), (cache["v"], v_w), (cache["k_s"], ks_w),
                    (cache["v_s"], vs_w))
        else:
            rows = ((cache["k"], k), (cache["v"], v))
        smax = cache["k"].shape[1]
        ring = bool(cfg.sliding_window) and smax == cfg.sliding_window
        if idx.dim() == 1:
            # ragged decode (s == 1): per-slot write position; off the ring,
            # clamped so an idle slot whose index has run past the end
            # rewrites the last row
            wr = (idx % smax if ring else idx.clamp(max=smax - 1)).long()
            bix = torch.arange(b, device=x.device)
            for dst, src in rows:
                dst[bix, wr] = src[:, 0].to(dst.dtype)
        elif ring and s >= smax:
            # the last Smax rows of the block, rolled so that row t lands
            # at t % Smax (a ring cache is never int8)
            for dst, src in rows:
                dst.copy_(roll_seq(src[:, -smax:], s % smax))
        else:
            # uniform write of s rows at index (clamped to fit, like
            # dynamic_update_slice; on the ring, one row at index % Smax);
            # no host sync on the index
            start = idx % smax if ring and s == 1 else idx.clamp(max=smax - s)
            for dst, src in rows:
                write_rows(dst, start, src)
        if s > 1:
            # prefill from an empty cache: causal attention over the fresh
            # full-precision block
            out = kops.flash_attention(
                q, k, v, causal=True, sliding_window=cfg.sliding_window
            )
        elif quant:
            out = kops.decode_attention_q8(q, cache["k"], cache["k_s"], cache["v"],
                                           cache["v_s"], length=idx + 1)
        else:
            out = kops.decode_attention(q, cache["k"], cache["v"], length=idx + 1)
        idx.add_(s)
    out = hint(out, "batch", "seq", "heads", None)
    y = sharding.merge_heads(out) @ p["wo"]
    return hint(y, "batch", "seq", None)


def cross_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    kv_x: Optional[torch.Tensor] = None,
    cache: Optional[Params] = None,
) -> torch.Tensor:
    """Cross-attention of the decoder over the encoder's states: the
    reference's ``attention(..., kv_x=)``.  No RoPE.  With ``kv_x``
    (B,Senc,d), K and V are projected from it and, where ``cache``
    ({"k","v" (B,Senc,Hkv,Dh)} views) is given, written there in place
    (prefill); without it they are read from ``cache`` (decode).  The
    attention is flash, non-causal, with Sq != Sk."""
    hd = cfg.head_dim_
    b, s, _ = x.shape
    q = split_heads(x @ p["wq"], cfg.n_heads, hd)
    if kv_x is not None:
        k = split_heads(kv_x @ p["wk"], cfg.n_kv_heads, hd)
        v = split_heads(kv_x @ p["wv"], cfg.n_kv_heads, hd)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    else:
        k, v = cache["k"], cache["v"]
    out = kops.cross_attention(q, k, v)
    return sharding.merge_heads(out) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3): latent-compressed KV cache
# ---------------------------------------------------------------------------
def mla_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
) -> torch.Tensor:
    """Multi-head Latent Attention.  The cache stores only the compressed
    latent ``c_kv`` (B,Smax,kv_lora) and the shared rotary key ``k_pe``
    (B,Smax,rope), written in place like ``attention``'s (no ring, no int8).

    Without a cache, and at prefill, K and V are decompressed and attended
    by flash (D = nope + rope, Dv = v_head_dim).  A decode step never
    decompresses the cache: wkv_b's key half is folded into the query and
    its value half applied after attending over the latents, in f32
    einsums masked by ``arange(Smax) < index + 1`` -- the reference's
    weight absorption, which is not a kernel there either.

    YaRN (``cfg.yarn_factor``) changes the rotary tables and multiplies
    the scores by its mscale squared (``mla_score_gain``): the decode's
    scores directly, the prefill's through its queries (flash scales by
    1/sqrt(D) itself).

    Telemetry: an ``mla.attention`` span (``mode`` "decompressed" at
    prefill or without a cache, "absorbed" at decode; ``rows`` the latent
    rows attended: every slot's whole ``Smax`` at decode) and the counter
    ``mla_latent_rows_total`` of those rows."""
    tel = get_telemetry()
    with tel.tracer.span("mla.attention") as span:
        b, s, _ = x.shape
        absorbed = cache is not None and s == 1
        if tel.enabled:
            rows = b * (cache["c_kv"].shape[1] if absorbed else s)
            span.set(mode="absorbed" if absorbed else "decompressed", rows=rows)
            tel.metrics.counter("mla_latent_rows_total",
                                "latent rows MLA attended over").inc(rows)
        return _mla(p, x, cfg, positions, cache)


def _mla(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         cache: Optional[Params]) -> torch.Tensor:
    b, s, _ = x.shape
    nope, rope_d, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h, r = cfg.n_heads, cfg.kv_lora_rank
    eps = cfg.norm_eps

    q = apply_norm(p["q_norm"], x @ p["wq_a"], eps=eps) @ p["wq_b"]
    q = q.reshape(b, s, h, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    kv_a = x @ p["wkv_a"]
    c_kv = apply_norm(p["kv_norm"], kv_a[..., :r], eps=eps)
    sin, cos = rope_tables(positions, rope_d, cfg.rope_theta, cfg)
    q_pe = apply_rope(q_pe, sin, cos)
    k_pe = apply_rope(kv_a[..., r:][:, :, None, :], sin, cos)[:, :, 0]  # one shared head

    if cache is not None:
        idx = cache["index"]
        c_all, pe_all = cache["c_kv"], cache["k_pe"]
        smax = c_all.shape[1]
        if idx.dim() == 1:  # ragged decode (s == 1)
            wr = idx.clamp(max=smax - 1).long()
            bix = torch.arange(b, device=x.device)
            c_all[bix, wr] = c_kv[:, 0].to(c_all.dtype)
            pe_all[bix, wr] = k_pe[:, 0].to(pe_all.dtype)
        else:
            start = idx.clamp(max=smax - s)
            write_rows(c_all, start, c_kv)
            write_rows(pe_all, start, k_pe)
        lim = (idx + s).expand(b)
        idx.add_(s)
    if cache is not None and s == 1:
        # decode with weight absorption
        wb = p["wkv_b"].reshape(r, h, nope + vh).float()
        wb_k, wb_v = wb[..., :nope], wb[..., nope:]
        q_eff = torch.einsum("bshn,rhn->bshr", q_nope.float(), wb_k)
        scores = torch.einsum("bshr,btr->bhst", q_eff, c_all.float())
        scores = scores + torch.einsum("bshd,btd->bhst", q_pe.float(), pe_all.float())
        scores = scores / math.sqrt(nope + rope_d)
        gain = mla_score_gain(cfg)
        if gain != 1.0:
            scores = scores * gain
        valid = torch.arange(smax, device=x.device)[None, :] < lim[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], _NEG)
        pr = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", pr, c_all.float())
        out = torch.einsum("bshr,rhv->bshv", ctx, wb_v).to(x.dtype)
    else:
        # no cache / prefill: decompress K and V, attend over the fresh block
        kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, nope + vh)
        k = torch.cat([kv[..., :nope], k_pe[:, :, None, :].expand(b, s, h, rope_d)], dim=-1)
        v = kv[..., nope:].contiguous()
        q = torch.cat([q_nope, q_pe], dim=-1)
        gain = mla_score_gain(cfg)  # flash scales by 1/sqrt(D) itself
        if gain != 1.0:
            q = q * gain
        out = kops.flash_attention(q, k, v, causal=True)
    y = sharding.merge_heads(out) @ p["wo"]
    return hint(y, "batch", "seq", None)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["w_in"]))
    else:  # gelu; jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_in"], approximate="tanh")
    h = hint(h, "batch", "seq", "mlp")
    # the row-parallel product's partial sums are reduced here, where GSPMD
    # reduces them: DTensor would carry them on through the residual and the
    # next norm, and then gather the next layer's weights to multiply them
    # whole on every rank
    return hint(h @ p["w_out"], "batch", "seq", None)


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if sharding.is_dtensor(table):
        return hint(_embed_local(table, tokens), "batch", "seq", None)
    return hint(table[tokens], "batch", "seq", None)


def _embed_local(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup of a DTensor table, rank by rank in ``local_map``: the
    table's fsdp shards of d are gathered, each rank looks up the tokens of
    its rows in its slice of the vocabulary (zeros for the others), and the
    partial rows add up over the vocabulary's shards.  DTensor's own rule
    for the lookup's backward (an ``index_put``) fails in torch 2.11."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not sharding.is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    vocab = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in table.placements]
    tok = [Replicate() if isinstance(v, Shard) else p for v, p in zip(vocab, tokens.placements)]
    table, tokens = table.redistribute(mesh, vocab), tokens.redistribute(mesh, tok)
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, vocab)
    out = [Partial() if isinstance(v, Shard) else p for v, p in zip(vocab, tok)]
    grad = [Partial() if isinstance(p, Shard) else v for v, p in zip(vocab, tok)]

    def lookup(tab, t):
        n = tab.shape[0]
        rows = t.long() - offset[0]
        inside = (rows >= 0) & (rows < n)
        return tab[rows.clamp(0, n - 1)] * inside[..., None].to(tab.dtype)

    return local_map(lookup, out_placements=out, in_placements=(vocab, tok),
                     in_grad_placements=(grad, tok), device_mesh=mesh)(table, tokens)


def lm_logits(table_or_w: torch.Tensor, x: torch.Tensor, tied: bool) -> torch.Tensor:
    w = table_or_w.T if tied else table_or_w
    return hint(x.float() @ w.float(), "batch", "seq", "vocab")
