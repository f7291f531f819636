"""The ``mla`` kind: DeepSeek-V3 (arXiv:2412.19437; hf
``deepseek-ai/DeepSeek-V3`` config.json), one rank's share of its experts.

Every layer attends by multi-head latent attention (MLA); the first
``n_dense_layers`` have a SwiGLU FFN of width ``d_ff``, the rest an MoE:
the ``noaux_tc`` router over ``n_routed_experts`` experts, of which this
rank holds ``n_experts`` from global id ``expert_offset``, plus
``n_shared_experts`` shared experts of width ``moe_d_ff`` each.

Weights (``leaves``): the program's layout, weights ``(d_in, d_out)``,
group ``"0"`` the dense layers and group ``"1"`` the MoE layers, each
stacked; the router and its score-correction bias f32.

The plain reference (``Reference``): this decoder in float32 with TF32
off, one sequence at a time and one layer at a time.  It imports nothing
of the program and is handed only what the benchmark made: the weights,
the prompt and, to be judged, the tokens the program served and the
expert selection it made.  What it follows (DeepSeek's own inference code
and the HF config):
  * RMSNorm with eps ``norm_eps`` (1e-6) before attention and FFN, on the
    query and latent compressions, and before the head;
  * MLA, decompressed: q = W_qb norm(W_qa x) split into (nope, rope) per
    head; the latent c = norm(W_kva x)[:kv_lora] and one rotary key shared
    by every head from the rest; K_nope and V per head from W_kvb c;
    causal attention over nope + rope with the score scale
    1/sqrt(nope + rope) x mscale^2, mscale = 0.1 ln(factor) + 1 (YaRN with
    ``yarn_mscale_all_dim``), attended in blocks of queries;
  * YaRN RoPE on interleaved (even, odd) pairs, base ``rope_theta``: the
    frequencies with more than ``yarn_beta_fast`` turns over
    ``yarn_original_len`` positions kept, those with fewer than
    ``yarn_beta_slow`` divided by ``yarn_factor``, a linear ramp between,
    the tables scaled by mscale(``yarn_mscale``) / mscale(``yarn_mscale_all_dim``);
  * the router: s = sigmoid(x W_r) (f32); the choice reads s + bias; the
    experts in ``n_group`` groups, each ranked by the sum of its two best
    biased scores, the best ``topk_group`` kept; the top k of the kept
    groups; gates from the unbiased s over the k, normalised to sum 1 and
    scaled by ``routed_scaling_factor``;
  * the held experts' share: each (token, choice) routed to a held expert
    adds gate x SwiGLU_e(x); the shared experts' SwiGLU of x is added once.

Departures from the published model, each a cut of the deployment:
  * the experts not held here give nothing: their part of each MoE
    layer's output would come from the other ranks of the expert-parallel
    group (EP32 in DeepSeek-V3's prefill deployment), and the layer passes
    on the partial sum, as the program does;
  * ``n_layers`` layers: the first pipeline stage; the final norm and the
    head are applied after them, so the logits are this stage's;
  * the multi-token-prediction module is not run;
  * the expert selection is the program's (``routes``): a discrete choice
    that rounding flips where scores nearly tie; ``route_gap`` checks it
    against this router, which drops no token (``keep`` all True).

Useful FLOPs (``token_flops_but_attention`` ... ``decode_flops``): what a
token needs.  A token through one layer: the five MLA projections (its
own K and V decompressed), causal attention over the p + 1 keys it sees
(QK^T over nope + rope and PV over v), and the FFN: SwiGLU, or the router,
the shared experts and, for the routed ones, the expected share held here,
``experts_per_token`` x ``n_experts`` / ``n_routed_experts`` SwiGLUs (a
uniform routing's; the rows actually routed are the device's work, priced
per launch by ``moe.expert_roofline``).  The head runs once a prefill (the
last prompt position, all the program computes) and once a decoded token.
A multiply-add counts 2.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Route = Tuple[torch.Tensor, torch.Tensor]  # (selected experts (n, k) long, kept (n, k) bool)

_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _qdq_fp8(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with an absmax scale per tensor
    (dim None) or per row along ``dim``, back in float32 (``gqa``'s)."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp(min=1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# -- weights -------------------------------------------------------------------
def _attn_leaves(c: Dict[str, Any], g: tuple, n: int) -> List[tuple]:
    d, h = c["d_model"], c["n_heads"]
    ql, kl = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope, vh = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    a = g + ("attn",)
    return [
        (g + ("ln1", "scale"), (n, d), "norm", 0.0, False),
        (g + ("ln2", "scale"), (n, d), "norm", 0.0, False),
        (a + ("wq_a",), (n, d, ql), "normal", d ** -0.5, False),
        (a + ("q_norm", "scale"), (n, ql), "norm", 0.0, False),
        (a + ("wq_b",), (n, ql, h * (nope + rope)), "normal", ql ** -0.5, False),
        (a + ("wkv_a",), (n, d, kl + rope), "normal", d ** -0.5, False),
        (a + ("kv_norm", "scale"), (n, kl), "norm", 0.0, False),
        (a + ("wkv_b",), (n, kl, h * (nope + vh)), "normal", kl ** -0.5, False),
        (a + ("wo",), (n, h * vh, d), "normal", (h * vh) ** -0.5, False),
    ]


def _swiglu_leaves(path: tuple, lead: tuple, d: int, f: int) -> List[tuple]:
    return [
        (path + ("w_gate",), lead + (d, f), "normal", d ** -0.5, False),
        (path + ("w_up",), lead + (d, f), "normal", d ** -0.5, False),
        (path + ("w_out",), lead + (f, d), "normal", f ** -0.5, False),
    ]


def leaves(config: Dict[str, Any]) -> List[tuple]:
    """Every parameter: the embedding, final norm and head, then group "0"
    (the dense layers) and group "1" (the MoE layers)."""
    c = config
    d, v = c["d_model"], c["vocab_size"]
    lead, moe = c["n_dense_layers"], c["n_layers"] - c["n_dense_layers"]
    r, e, f = router_width(c), c["n_experts"], c["moe_d_ff"]
    out: List[tuple] = [
        (("embedding",), (v, d), "normal", 0.02, False),
        (("ln_f", "scale"), (d,), "norm", 0.0, False),
        (("lm_head",), (d, v), "normal", d ** -0.5, False),
    ]
    g0, g1 = ("groups", "0"), ("groups", "1")
    out += _attn_leaves(c, g0, lead) + _swiglu_leaves(g0 + ("mlp",), (lead,), d, c["d_ff"])
    m = g1 + ("moe",)
    out += _attn_leaves(c, g1, moe) + [
        (m + ("router",), (moe, d, r), "normal", 0.02, True),
        (m + ("router_bias",), (moe, r), "normal", 0.05, True),
    ]
    out += _swiglu_leaves(m + ("experts",), (moe, e), d, f)
    out += _swiglu_leaves(m + ("shared",), (moe,), d, f * c["n_shared_experts"])
    return out


def router_width(c: Dict[str, Any]) -> int:
    return c.get("n_routed_experts") or c["n_experts"]


def moe_layers(config: Dict[str, Any]) -> int:
    """Every layer past the leading dense ones routes."""
    return config["n_layers"] - config["n_dense_layers"]


def keep(sel: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    """The router drops nothing: every (token, choice) is taken."""
    return torch.ones_like(sel, dtype=torch.bool)


# -- the router ---------------------------------------------------------------
def _group_rank(biased: torch.Tensor, c: Dict[str, Any]) -> torch.Tensor:
    """(n, R) biased scores -> (n, G) group scores: each group's two best."""
    n, r = biased.shape
    return biased.reshape(n, c["n_group"], r // c["n_group"]).topk(2, dim=-1).values.sum(-1)


def select(biased: torch.Tensor, c: Dict[str, Any]) -> torch.Tensor:
    """The router's choice from (n, R) biased scores: the top k experts of
    the ``topk_group`` best groups -> (n, k) global ids."""
    n, r = biased.shape
    g = c.get("n_group", 1)
    if g > 1:
        best = _group_rank(biased, c).topk(c["topk_group"], dim=-1).indices
        kept = torch.zeros((n, g), dtype=torch.bool, device=biased.device)
        kept.scatter_(1, best, True)
        biased = biased.masked_fill(~kept.repeat_interleave(r // g, dim=1), float("-inf"))
    return biased.topk(c["experts_per_token"], dim=-1).indices


def selection_gap(biased: torch.Tensor, sel: torch.Tensor, c: Dict[str, Any]) -> float:
    """How far a selection (n, k) lies from one this router could make from
    the (n, R) biased scores ``biased``, at worst over positions and
    selected experts: for each selected expert, the larger of (a) how far
    its group's score lies below the ``topk_group``-th best group score and
    (b) how far its biased score lies below the k-th best among the groups
    the selection spans, filled up to ``topk_group`` with the best others.
    0 where the selection is this router's own, and where it differs only
    by ties."""
    n, r = biased.shape
    k, g = c["experts_per_token"], c.get("n_group", 1)
    if g <= 1:
        kth = biased.topk(k, dim=-1).values[:, -1]
        return float((kth - biased.gather(1, sel).min(-1).values).clamp(min=0).max())
    per = r // g
    rank = _group_rank(biased, c)  # (n, G)
    gk = rank.topk(c["topk_group"], dim=-1).values[:, -1]
    sel_groups = sel // per
    group_gap = (gk[:, None] - rank.gather(1, sel_groups)).clamp(min=0).amax(-1)
    spanned = torch.zeros((n, g), dtype=torch.bool, device=biased.device)
    spanned.scatter_(1, sel_groups, True)
    # fill each row up to topk_group groups with its best groups not spanned
    fill = rank.masked_fill(spanned, float("-inf")).argsort(dim=-1, descending=True)
    need = (c["topk_group"] - spanned.sum(-1)).clamp(min=0)
    take = torch.arange(g, device=biased.device)[None, :] < need[:, None]
    kept = spanned.clone()
    kept.scatter_(1, fill, take | kept.gather(1, fill))
    masked = biased.masked_fill(~kept.repeat_interleave(per, dim=1), float("-inf"))
    kth = masked.topk(k, dim=-1).values[:, -1]
    expert_gap = (kth[:, None] - biased.gather(1, sel)).clamp(min=0).amax(-1)
    return float(torch.maximum(group_gap, expert_gap).max())


def route_gaps(judge: List[torch.Tensor], chooser: List[torch.Tensor],
               config: Dict[str, Any]) -> float:
    """The widest ``selection_gap`` of the selection that ``chooser``'s
    biased scores make, judged by ``judge``'s, over layers (both per MoE
    layer, (n, R))."""
    gap = 0.0
    for zj, zc in zip(judge, chooser):
        gap = max(gap, selection_gap(zj, select(zc, config), config))
    return gap


# -- the model ----------------------------------------------------------------
def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def rope_frequencies(c: Dict[str, Any]) -> Tuple[torch.Tensor, float]:
    """The rotary inverse frequencies (rope/2,) and the tables' scale."""
    dim, theta = c["qk_rope_head_dim"], float(c.get("rope_theta", 1e4))
    half = dim // 2
    plain = 1.0 / theta ** (torch.arange(half, dtype=torch.float64) * 2 / dim)
    factor = float(c.get("yarn_factor") or 0.0)
    if not factor:
        return plain.float(), 1.0
    orig = c["yarn_original_len"]

    def turns_dim(turns: float) -> float:  # the pair index that turns ``turns`` times
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(turns_dim(c["yarn_beta_fast"])), 0)
    high = min(math.ceil(turns_dim(c["yarn_beta_slow"])), dim - 1)
    high = high + 0.001 if high == low else high
    ramp = ((torch.arange(half, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    freqs = plain / factor * ramp + plain * (1 - ramp)
    scale = _yarn_mscale(factor, c.get("yarn_mscale", 1.0)) / _yarn_mscale(
        factor, c.get("yarn_mscale_all_dim", 0.0))
    return freqs.float(), scale


def score_scale(c: Dict[str, Any]) -> float:
    """1/sqrt(nope + rope), times mscale^2 under YaRN with mscale_all_dim."""
    s = 1.0 / math.sqrt(c["qk_nope_head_dim"] + c["qk_rope_head_dim"])
    if c.get("yarn_factor") and c.get("yarn_mscale_all_dim"):
        s *= _yarn_mscale(c["yarn_factor"], c["yarn_mscale_all_dim"]) ** 2
    return s


class Reference:
    """DeepSeek-V3's decoder over the benchmark's weights.

    ``precision`` "f32" is the reference; "fp8" is the control: every
    linear layer's weight (per tensor) and input (per row) rounded through
    float8 e4m3, the router and the rest as the reference."""

    def __init__(self, config: Dict[str, Any], params: Dict[str, Any], precision: str = "f32",
                 block: int = 256):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision f32 or fp8, got {precision!r}")
        self.c = config
        self.p = params
        self.fp8 = precision == "fp8"
        self.block = block
        self.eps = float(config.get("norm_eps", 1e-6))
        self.freqs, self.rope_scale = rope_frequencies(config)
        self.scale = score_scale(config)
        #: the last ``logits`` call's biased router scores, (n, R) f32 per MoE layer
        self.router_logits: List[torch.Tensor] = []

    # -- pieces --------------------------------------------------------------
    def _w(self, t: torch.Tensor) -> torch.Tensor:
        w = t.to(torch.float32)
        return _qdq_fp8(w, None) if self.fp8 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_qdq_fp8(x, -1) if self.fp8 else x) @ self._w(w)

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale.to(torch.float32)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (n, ..., rope) rotated on interleaved pairs at positions pos (n,)."""
        ang = pos.to(torch.float32)[:, None] * self.freqs.to(x.device)
        s, c = torch.sin(ang) * self.rope_scale, torch.cos(ang) * self.rope_scale
        shape = (ang.shape[0],) + (1,) * (x.dim() - 2) + (ang.shape[1],)
        s, c = s.reshape(shape), c.reshape(shape)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).flatten(-2)

    def _swiglu(self, x: torch.Tensor, w: Dict[str, torch.Tensor], i) -> torch.Tensor:
        a = self._mm(x, w["w_gate"][i])
        return self._mm(F.silu(a) * self._mm(x, w["w_up"][i]), w["w_out"][i])

    def _attention(self, a: Dict[str, torch.Tensor], i: int, x: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
        """MLA of layer ``i`` over the whole sequence x (n, d), causal."""
        c = self.c
        n = x.shape[0]
        h, kl = c["n_heads"], c["kv_lora_rank"]
        nope, rope, vh = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        q = self._mm(self._norm(self._mm(x, a["wq_a"][i]), a["q_norm"]["scale"][i]),
                     a["wq_b"][i]).reshape(n, h, nope + rope)
        q_nope, q_pe = q[..., :nope], self._rope(q[..., nope:], pos)
        kv_a = self._mm(x, a["wkv_a"][i])
        latent = self._norm(kv_a[:, :kl], a["kv_norm"]["scale"][i])
        k_pe = self._rope(kv_a[:, kl:], pos)  # (n, rope), shared by every head
        kv = self._mm(latent, a["wkv_b"][i]).reshape(n, h, nope + vh)
        k_nope = kv[..., :nope].permute(1, 2, 0).contiguous()  # (h, nope, n)
        v = kv[..., nope:].transpose(0, 1).contiguous()  # (h, n, v)
        del kv
        out = torch.empty((n, h, vh), dtype=torch.float32, device=x.device)
        for s0 in range(0, n, self.block):
            s1 = min(s0 + self.block, n)  # queries s0..s1-1 see keys 0..s1-1
            scores = torch.matmul(q_nope[s0:s1].transpose(0, 1), k_nope[:, :, :s1])
            scores += torch.matmul(q_pe[s0:s1].transpose(0, 1), k_pe[:s1].T)
            scores *= self.scale
            qpos = torch.arange(s0, s1, device=x.device)[:, None]
            scores.masked_fill_(torch.arange(s1, device=x.device)[None, :] > qpos, float("-inf"))
            out[s0:s1] = (torch.softmax(scores, dim=-1) @ v[:, :s1]).transpose(0, 1)
            del scores
        return self._mm(out.reshape(n, h * vh), a["wo"][i])

    def _moe(self, mp: Dict[str, Any], i: int, x: torch.Tensor, route: Optional[Route]):
        """The held experts' part and the shared experts for layer ``i`` of
        the MoE group; the route gap of the given selection (its own
        selection where ``route`` is None)."""
        c = self.c
        z = x @ mp["router"][i].to(torch.float32)  # the router stays f32
        scores = torch.sigmoid(z)
        biased = scores + mp["router_bias"][i].to(torch.float32)
        self.router_logits.append(biased)
        sel = select(biased, c) if route is None else route[0]
        gap = selection_gap(biased, sel, c)
        gates = scores.gather(1, sel)
        gates = gates / gates.sum(-1, keepdim=True)
        gates = gates * float(c.get("routed_scaling_factor", 1.0))
        y = self._swiglu(x, mp["shared"], i)
        lo = int(c.get("expert_offset", 0))
        for e in range(c["n_experts"]):
            tok, choice = torch.nonzero(sel == lo + e, as_tuple=True)
            if tok.numel():
                out = self._swiglu(x[tok], mp["experts"], (i, e))
                y.index_add_(0, tok, out * gates[tok, choice][:, None])
        return y, gap

    def logits(self, tokens: Sequence[int], out_positions: Sequence[int],
               image: Optional[torch.Tensor] = None,
               routes: Optional[List[Route]] = None) -> Tuple[torch.Tensor, float]:
        """Teacher-forced forward over ``tokens`` -> (f32 logits at
        ``out_positions`` (n_out, V), the widest route gap over the MoE
        layers).  ``routes``: one ``Route`` per MoE layer, global expert
        ids (None: the reference's own selection).  ``image`` is not read
        (no frontend)."""
        p, c = self.p, self.c
        dev = p["embedding"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        x = p["embedding"][tok].to(torch.float32)
        pos = torch.arange(tok.numel(), device=dev)
        lead = c["n_dense_layers"]
        route_gap = 0.0
        self.router_logits = []
        for layer in range(c["n_layers"]):
            gi, i = (0, layer) if layer < lead else (1, layer - lead)
            g = p["groups"][gi]
            x = x + self._attention(g["attn"], i, self._norm(x, g["ln1"]["scale"][i]), pos)
            xn = self._norm(x, g["ln2"]["scale"][i])
            if gi == 0:
                x = x + self._swiglu(xn, g["mlp"], i)
            else:
                y, gap = self._moe(g["moe"], i, xn, routes[i] if routes is not None else None)
                route_gap = max(route_gap, gap)
                x = x + y
        out = torch.as_tensor(list(out_positions), dtype=torch.long, device=dev)
        xo = self._norm(x[out], p["ln_f"]["scale"])
        return self._mm(xo, p["lm_head"]), route_gap


# -- useful FLOPs ---------------------------------------------------------------
def _head(c: Dict[str, Any]) -> int:
    return 2 * c["d_model"] * c["vocab_size"]


def _layers_per_token(c: Dict[str, Any]) -> int:
    d, h = c["d_model"], c["n_heads"]
    ql, kl = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope, vh = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    attn = 2 * (d * ql + ql * h * (nope + rope) + d * (kl + rope) + kl * h * (nope + vh)
                + h * vh * d)
    dense = 3 * 2 * d * c["d_ff"]
    f = c["moe_d_ff"]
    routed = c["experts_per_token"] * c["n_experts"] / router_width(c)
    moe = 2 * d * router_width(c) + (c["n_shared_experts"] + routed) * 3 * 2 * d * f
    lead = c["n_dense_layers"]
    return int(c["n_layers"] * attn + lead * dense + (c["n_layers"] - lead) * moe)


def token_flops_but_attention(c: Dict[str, Any]) -> int:
    """One token through every layer's projections and FFN, and the head."""
    return _layers_per_token(c) + _head(c)


def attention_flops(c: Dict[str, Any], position: int) -> int:
    """The attention of one token at ``position`` over every layer."""
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return c["n_layers"] * 2 * c["n_heads"] * (position + 1) * (qk + c["v_head_dim"])


def prefill_flops(c: Dict[str, Any], prompt_len: int, image: bool = False) -> int:
    """A prompt of ``prompt_len`` true tokens through the layers, and the
    head at its last position alone."""
    return (prompt_len * _layers_per_token(c) + _head(c)
            + sum(attention_flops(c, p) for p in range(prompt_len)))


def decode_flops(c: Dict[str, Any], positions: Iterable[int]) -> int:
    """One decode step: one token at each active slot's position."""
    per = token_flops_but_attention(c)
    return sum(per + attention_flops(c, p) for p in positions)
