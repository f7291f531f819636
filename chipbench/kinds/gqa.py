"""The ``gqa`` kind: a decoder of grouped-query attention blocks, each
with a SwiGLU or a top-k MoE FFN, and an optional patch frontend.  One
layer group, stacked.

Weights (``leaves``): the program's layout, weights ``(d_in, d_out)``,
one group ``"0"`` of ``n_layers`` layers; drawn in the order listed.

Useful FLOPs (``token_flops_but_attention`` ... ``decode_flops``): what a
token needs, not what the program computes.  A token at position p
(0-based) through one layer: the Q, K, V and output projections, causal
attention over the p + 1 keys it sees (QK^T and PV, capped by a sliding
window), and the FFN: SwiGLU's three matrices, or the router and
``experts_per_token`` experts.  Then the LM head.  Padding, experts run on
empty capacity slots and logits nobody reads are not useful.  A
multiply-add counts 2.

The plain reference (``Reference``): this decoder in float32 with TF32
off, one sequence at a time and one layer at a time.  It imports nothing
of the program and is handed only what the benchmark made: the weights,
the prompt, the image and, to be judged, the tokens the program served.

What it follows (Mistral's own ``mistral-inference`` for the attention
block, Mixtral's paper for the experts):
  * RMSNorm (eps 1e-5) before attention and FFN, and before the head;
  * RoPE on interleaved (even, odd) pairs, base ``rope_theta``;
  * causal GQA attention with an optional sliding window, scale 1/sqrt(hd);
  * SwiGLU: silu(x Wg) * (x Wu) Wo;
  * MoE: an f32 router, softmax, top-k, the k gates renormalised; each
    expert a SwiGLU.  The configuration states a capacity factor: in each
    routing call (one prefill, or one decode step over every slot) an
    expert takes at most C tokens, token-major, C = max(4, ceil(Tg k / E
    cf)) over groups of ~1024 tokens; a token beyond it gets nothing from
    that expert (``capacity_keep``).
  * a VLM's image: its patch embeddings projected to d_model replace the
    leading positions' token embeddings.

Which experts a token was routed to is a discrete choice that rounding can
flip where two router logits nearly tie, and with a capacity it also
depends on the other tokens of the call.  So for an MoE model the caller
gives the selection the program made (``routes``); the reference checks it
against its own router (``route_gap``) and computes everything else itself.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def leaves(config: Dict[str, Any]) -> List[tuple]:
    """Every parameter of a GQA decoder with a SwiGLU or top-k MoE FFN and
    an optional patch frontend, one layer group stacked."""
    d, v, L = config["d_model"], config["vocab_size"], config["n_layers"]
    h, kv = config["n_heads"], config["n_kv_heads"]
    hd = config.get("head_dim") or d // h
    f, e = config["d_ff"], config.get("n_experts", 0)
    out: List[tuple] = [
        (("embedding",), (v, d), "normal", 0.02, False),
        (("ln_f", "scale"), (d,), "norm", 0.0, False),
        (("lm_head",), (d, v), "normal", d ** -0.5, False),
    ]
    if config.get("frontend"):
        fd = config["frontend_dim"]
        out.append((("frontend", "patch_proj"), (fd, d), "normal", fd ** -0.5, False))
    g = ("groups", "0")
    out += [
        (g + ("ln1", "scale"), (L, d), "norm", 0.0, False),
        (g + ("ln2", "scale"), (L, d), "norm", 0.0, False),
        (g + ("attn", "wq"), (L, d, h * hd), "normal", d ** -0.5, False),
        (g + ("attn", "wk"), (L, d, kv * hd), "normal", d ** -0.5, False),
        (g + ("attn", "wv"), (L, d, kv * hd), "normal", d ** -0.5, False),
        (g + ("attn", "wo"), (L, h * hd, d), "normal", (h * hd) ** -0.5, False),
    ]
    if e:
        m = g + ("moe",)
        out += [
            (m + ("router",), (L, d, e), "normal", 0.02, True),
            (m + ("experts", "w_gate"), (L, e, d, f), "normal", d ** -0.5, False),
            (m + ("experts", "w_up"), (L, e, d, f), "normal", d ** -0.5, False),
            (m + ("experts", "w_out"), (L, e, f, d), "normal", f ** -0.5, False),
        ]
    else:
        out += [
            (g + ("mlp", "w_gate"), (L, d, f), "normal", d ** -0.5, False),
            (g + ("mlp", "w_up"), (L, d, f), "normal", d ** -0.5, False),
            (g + ("mlp", "w_out"), (L, f, d), "normal", f ** -0.5, False),
        ]
    return out


Route = Tuple[torch.Tensor, torch.Tensor]  # (selected experts (n, k) long, kept (n, k) bool)

_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _qdq_fp8(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with an absmax scale per tensor
    (dim None) or per row along ``dim``, back in float32."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp(min=1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def capacity_keep(sel: torch.Tensor, n_experts: int, capacity_factor: float) -> torch.Tensor:
    """Which (token, choice) pairs of one routing call an expert takes:
    sel (T, k) in the router's order; groups of ~1024 tokens (a power of
    two), each expert at most C of a group's pairs, first come (token, then
    choice) first served."""
    t, k = sel.shape
    g = max(1, t // 1024)
    g = 1 << (g - 1).bit_length()
    tg = t // g
    cap = min(max(4, math.ceil(tg * k / n_experts * capacity_factor)), tg * k)
    onehot = F.one_hot(sel.reshape(g, tg * k), n_experts).to(torch.int64)
    before = (torch.cumsum(onehot, dim=1) - onehot).gather(2, sel.reshape(g, tg * k, 1))
    return (before < cap).reshape(t, k)


def moe_layers(config: Dict[str, Any]) -> int:
    """Every layer routes where the configuration has experts."""
    return config["n_layers"] if config.get("n_experts") else 0


def keep(sel: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    """The configuration's capacity drops (``capacity_keep``)."""
    return capacity_keep(sel, config["n_experts"], config.get("capacity_factor", 1.25))


class Reference:
    """The model of one configuration over the benchmark's weights.

    ``precision`` "f32" is the reference; "fp8" is the control: every
    linear layer's weight (per tensor) and input (per row) rounded through
    float8 e4m3, the rest as the reference."""

    def __init__(self, config: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision f32 or fp8, got {precision!r}")
        self.c = config
        self.p = params
        self.fp8 = precision == "fp8"
        d, h = config["d_model"], config["n_heads"]
        self.hd = config.get("head_dim") or d // h
        self.n_experts = config.get("n_experts", 0)
        #: the last ``logits`` call's router logits, (n, E) f32 per MoE layer
        self.router_logits: List[torch.Tensor] = []

    # -- pieces --------------------------------------------------------------
    def _w(self, t: torch.Tensor) -> torch.Tensor:
        w = t.to(torch.float32)
        return _qdq_fp8(w, None) if self.fp8 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_qdq_fp8(x, -1) if self.fp8 else x) @ w

    @staticmethod
    def _norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * scale.to(torch.float32)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        half = self.hd // 2
        freqs = 1.0 / (self.c.get("rope_theta", 1e4) ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.to(torch.float32)[:, None] * freqs
        s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).flatten(-2)

    def _attention(self, q, k, v, chunk: int = 512) -> torch.Tensor:
        """q (n, H, hd), k/v (n, Hkv, hd), causal with the window -> (n, H*hd)."""
        n, h, hd = q.shape
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # (H, n, hd)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        window = self.c.get("sliding_window")
        kpos = torch.arange(n, device=q.device)
        out = torch.empty((n, h, hd), dtype=torch.float32, device=q.device)
        for i in range(0, n, chunk):
            qi = q[i:i + chunk].transpose(0, 1)  # (H, c, hd)
            qpos = torch.arange(i, i + qi.shape[1], device=q.device)[:, None]
            mask = kpos[None, :] <= qpos
            if window:
                mask &= kpos[None, :] > qpos - window
            s = (qi @ k.transpose(1, 2)) / math.sqrt(hd)
            s = s.masked_fill(~mask, float("-inf"))
            out[i:i + chunk] = (torch.softmax(s, dim=-1) @ v).transpose(0, 1)
        return out.reshape(n, h * hd)

    def _swiglu(self, x, wg, wu, wo) -> torch.Tensor:
        a = self._mm(x, wg)
        return self._mm(F.silu(a) * self._mm(x, wu), wo)

    def _moe(self, x: torch.Tensor, layer: int, route: Route) -> Tuple[torch.Tensor, float]:
        mp = self.p["groups"][0]["moe"]
        k = self.c["experts_per_token"]
        z = x @ mp["router"][layer].to(torch.float32)  # the router stays f32
        self.router_logits.append(z)
        sel, keep = route
        gates = torch.softmax(z, dim=-1).gather(1, sel)
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        kth = torch.topk(z, k, dim=-1).values[:, -1]
        gap = float((kth - z.gather(1, sel).min(-1).values).clamp(min=0).max())
        y = torch.zeros_like(x)
        ex = mp["experts"]
        for e in range(self.n_experts):
            tok, choice = torch.nonzero((sel == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            out = self._swiglu(x[tok], self._w(ex["w_gate"][layer, e]),
                               self._w(ex["w_up"][layer, e]), self._w(ex["w_out"][layer, e]))
            y.index_add_(0, tok, out * gates[tok, choice][:, None])
        return y, gap

    # -- the model -----------------------------------------------------------
    def logits(self, tokens: Sequence[int], out_positions: Sequence[int],
               image: Optional[torch.Tensor] = None,
               routes: Optional[List[Route]] = None) -> Tuple[torch.Tensor, float]:
        """Teacher-forced forward over ``tokens`` -> (f32 logits at
        ``out_positions`` (n_out, V), the widest route gap over the MoE
        layers: how far the reference's router logit of a given expert lies
        below its own k-th best; 0 for a dense model).  ``routes``: one
        ``Route`` per layer for an MoE model."""
        p, c = self.p, self.c
        dev = p["embedding"].device
        g = p["groups"][0]
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        n = tok.numel()
        x = p["embedding"][tok].to(torch.float32)
        if image is not None and c.get("frontend"):
            m = min(image.shape[0], n)
            x[:m] = self._mm(image[:m].to(torch.float32), self._w(p["frontend"]["patch_proj"]))
        pos = torch.arange(n, device=dev)
        h, kv, hd = c["n_heads"], c["n_kv_heads"], self.hd
        route_gap = 0.0
        self.router_logits = []
        for layer in range(c["n_layers"]):
            a = g["attn"]
            xn = self._norm(x, g["ln1"]["scale"][layer])
            q = self._rope(self._mm(xn, self._w(a["wq"][layer])).reshape(n, h, hd), pos)
            k = self._rope(self._mm(xn, self._w(a["wk"][layer])).reshape(n, kv, hd), pos)
            v = self._mm(xn, self._w(a["wv"][layer])).reshape(n, kv, hd)
            x = x + self._mm(self._attention(q, k, v), self._w(a["wo"][layer]))
            xn = self._norm(x, g["ln2"]["scale"][layer])
            if self.n_experts:
                y, gap = self._moe(xn, layer, routes[layer])
                route_gap = max(route_gap, gap)
            else:
                mp = g["mlp"]
                y = self._swiglu(xn, self._w(mp["w_gate"][layer]), self._w(mp["w_up"][layer]),
                                 self._w(mp["w_out"][layer]))
            x = x + y
        out = torch.as_tensor(list(out_positions), dtype=torch.long, device=dev)
        xo = self._norm(x[out], p["ln_f"]["scale"])
        return self._mm(xo, self._w(p["lm_head"])), route_gap


def route_gaps(judge: List[torch.Tensor], chooser: List[torch.Tensor],
               config: Dict[str, Any]) -> float:
    """The widest gap by which an expert that ``chooser``'s router logits put
    in their top k lies below the k-th best of ``judge``'s, over layers and
    positions (both per MoE layer, (n, E))."""
    k = config["experts_per_token"]
    gap = 0.0
    for zj, zc in zip(judge, chooser):
        sel = torch.topk(zc, k, dim=-1).indices
        kth = torch.topk(zj, k, dim=-1).values[:, -1]
        gap = max(gap, float((kth - zj.gather(1, sel).min(-1).values).clamp(min=0).max()))
    return gap


def _dims(c: Dict[str, Any]):
    d, h, kv = c["d_model"], c["n_heads"], c["n_kv_heads"]
    hd = c.get("head_dim") or d // h
    return d, h, kv, hd


def token_flops_but_attention(c: Dict[str, Any]) -> int:
    """One token through every layer's projections and FFN, and the head."""
    d, h, kv, hd = _dims(c)
    proj = 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d
    f, e = c["d_ff"], c.get("n_experts", 0)
    if e:
        ffn = 2 * d * e + c["experts_per_token"] * 3 * 2 * d * f
    else:
        ffn = 3 * 2 * d * f
    return c["n_layers"] * (proj + ffn) + 2 * d * c["vocab_size"]


def attention_flops(c: Dict[str, Any], position: int) -> int:
    """The attention of one token at ``position`` over every layer."""
    _, h, _, hd = _dims(c)
    keys = position + 1
    if c.get("sliding_window"):
        keys = min(keys, c["sliding_window"])
    return c["n_layers"] * 2 * h * keys * 2 * hd


def prefill_flops(c: Dict[str, Any], prompt_len: int, image: bool = False) -> int:
    """A prompt of ``prompt_len`` true tokens; with ``image``, the image's
    patch projection over the positions it covers too."""
    total = prompt_len * token_flops_but_attention(c)
    total += sum(attention_flops(c, p) for p in range(prompt_len))
    if image and c.get("frontend"):
        total += min(c["frontend_len"], prompt_len) * 2 * c["frontend_dim"] * c["d_model"]
    return total


def decode_flops(c: Dict[str, Any], positions: Iterable[int]) -> int:
    """One decode step: one token at each active slot's position."""
    per = token_flops_but_attention(c)
    return sum(per + attention_flops(c, p) for p in positions)
