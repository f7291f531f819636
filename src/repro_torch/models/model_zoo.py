"""ArchConfig -> runnable model bundle: init / loss / prefill / decode.
Counterpart of ``repro/models/model_zoo.py``.

Parameters are a nested dict of tensors with the reference's pytree layout
(stacked per-group weights with a leading L dimension, weights
``(d_in, d_out)``).  Random weights come from a ``torch.Generator`` with the
reference's initializer scales; they are not the reference's numbers, so
parity tests copy the reference's weights over with ``bridge.params_to_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..device import resolve_device
from ..distribution import sharding
from ..tree import tree_leaves, tree_map
from .ssm import CONV_K, mamba_dims, mlstm_dims, slstm_ff_width
from .transformer import Model, torch_dtype

Params = Dict[str, Any]

__all__ = ["Leaf", "ModelBundle", "bundle", "param_specs"]


class Leaf(NamedTuple):
    """One parameter: its shape, initializer ("normal" with a scale, "ones",
    "zeros", or "fill" with ``values`` along the last axis) and dtype (None:
    the config's dtype)."""

    shape: Tuple[int, ...]
    init: str
    scale: Optional[float] = None
    dtype: Optional[torch.dtype] = None
    values: Optional[Tuple[float, ...]] = None


def _dense(d_in: int, d_out: int, lead=()) -> Leaf:
    return Leaf(lead + (d_in, d_out), "normal", (1.0 / d_in) ** 0.5)


def _norm(d: int, kind: str, lead=()) -> Params:
    p = {"scale": Leaf(lead + (d,), "ones")}
    if kind == "layernorm":
        p["bias"] = Leaf(lead + (d,), "zeros")
    return p


def _mlp(d: int, f: int, kind: str, lead=()) -> Params:
    p = {"w_out": _dense(f, d, lead)}
    if kind == "swiglu":
        p["w_gate"] = _dense(d, f, lead)
        p["w_up"] = _dense(d, f, lead)
    else:
        p["w_in"] = _dense(d, f, lead)
    return p


def _gqa(cfg: ArchConfig, lead=()) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    return {
        "wq": _dense(d, cfg.n_heads * hd, lead),
        "wk": _dense(d, cfg.n_kv_heads * hd, lead),
        "wv": _dense(d, cfg.n_kv_heads * hd, lead),
        "wo": _dense(cfg.n_heads * hd, d, lead),
    }


def _mla(cfg: ArchConfig, lead=()) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": _dense(d, cfg.q_lora_rank, lead),
        "q_norm": _norm(cfg.q_lora_rank, "rmsnorm", lead),
        "wq_b": _dense(cfg.q_lora_rank, h * (nope + rope_d), lead),
        "wkv_a": _dense(d, cfg.kv_lora_rank + rope_d, lead),
        "kv_norm": _norm(cfg.kv_lora_rank, "rmsnorm", lead),
        "wkv_b": _dense(cfg.kv_lora_rank, h * (nope + vh), lead),
        "wo": _dense(h * vh, d, lead),
    }


def _moe(cfg: ArchConfig, lead=()) -> Params:
    """Router (an f32 leaf: stable softmax in a bf16 model) over the
    router's width, the experts held stacked (E, d, f), and the shared
    expert, a SwiGLU of width moe_d_ff x n_shared_experts.  A sigmoid
    router also has its f32 score-correction bias (router width,), used
    only to choose."""
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    p = {
        "router": Leaf(lead + (d, cfg.router_width), "normal", 0.02, dtype=torch.float32),
        "experts": {"w_gate": _dense(d, f, lead + (e,)), "w_up": _dense(d, f, lead + (e,)),
                    "w_out": _dense(f, d, lead + (e,))},
    }
    if cfg.scoring_func == "sigmoid":
        p["router_bias"] = Leaf(lead + (cfg.router_width,), "normal", 0.05,
                                dtype=torch.float32)
    if cfg.n_shared_experts:
        p["shared"] = _mlp(d, f * cfg.n_shared_experts, "swiglu", lead)
    return p


def _attn_block(cfg: ArchConfig, lead=(), kind: str = "attn") -> Params:
    """An attention block ("attn": dense FFN of width d_ff; "moe": the MoE
    layer), its attention GQA or MLA as the config says."""
    d = cfg.d_model
    p = {
        "ln1": _norm(d, cfg.norm, lead),
        "ln2": _norm(d, cfg.norm, lead),
        "attn": _mla(cfg, lead) if cfg.attention == "mla" else _gqa(cfg, lead),
    }
    if kind == "moe":
        p["moe"] = _moe(cfg, lead)
    else:
        p["mlp"] = _mlp(d, cfg.d_ff, cfg.mlp, lead)
    return p


def _mamba2_block(cfg: ArchConfig, lead=()) -> Params:
    d = cfg.d_model
    d_inner, h, _, n = mamba_dims(cfg)
    f32 = torch.float32  # A, dt bias and skip stay f32 in a bf16 model
    return {
        "ln1": _norm(d, cfg.norm, lead),
        "mixer": {
            "w_in": _dense(d, 2 * d_inner + 2 * n + h, lead),
            "conv_w": Leaf(lead + (CONV_K, d_inner + 2 * n), "normal", 0.1),
            "a_log": Leaf(lead + (h,), "zeros", dtype=f32),  # A = -exp(a_log) = -1
            "dt_bias": Leaf(lead + (h,), "zeros", dtype=f32),
            "d_skip": Leaf(lead + (h,), "ones", dtype=f32),
            "norm": _norm(d_inner, "rmsnorm", lead),
            "w_out": _dense(d_inner, d, lead),
        },
    }


def _mlstm_block(cfg: ArchConfig, lead=()) -> Params:
    d = cfg.d_model
    h, dh = mlstm_dims(cfg)
    return {
        "ln1": _norm(d, cfg.norm, lead),
        "mixer": {
            "w_up": _dense(d, 2 * d, lead),
            "w_z": _dense(d, 2 * d, lead),
            "wq": _dense(2 * d, h * dh, lead),
            "wk": _dense(2 * d, h * dh, lead),
            "wv": _dense(2 * d, h * dh, lead),
            "w_if": Leaf(lead + (2 * d, 2 * h), "normal", 0.02),
            # input gates start at 0, forget gates at 3 (sigmoid ~0.95)
            "if_bias": Leaf(lead + (2 * h,), "fill", dtype=torch.float32,
                            values=(0.0,) * h + (3.0,) * h),
            "norm": _norm(2 * d, "rmsnorm", lead),
            "w_down": _dense(2 * d, d, lead),
        },
    }


def _slstm_block(cfg: ArchConfig, lead=()) -> Params:
    d, f = cfg.d_model, slstm_ff_width(cfg)
    return {
        "ln1": _norm(d, cfg.norm, lead),
        "mixer": {
            "w_gates": _dense(d, 4 * d, lead),  # i, f, z, o
            "r_gates": _dense(d, 4 * d, lead),  # recurrent
            "g_bias": Leaf(lead + (4 * d,), "zeros", dtype=torch.float32),
            "norm": _norm(d, "rmsnorm", lead),
            "w_ff": {"w_out": _dense(f, d, lead), "w_gate": _dense(d, f, lead),
                     "w_up": _dense(d, f, lead)},
        },
    }


def param_specs(cfg: ArchConfig) -> Params:
    """The parameter tree with a ``Leaf`` per parameter; mirrors
    ``repro.models.transformer.Model.init`` (groups split as ``Model._groups``).
    DeepSeek's multi-token-prediction head (``mtp``) is run by ``Model.loss``
    only."""
    d = cfg.d_model
    specs: Params = {
        "embedding": Leaf((cfg.vocab_size, d), "normal", 0.02),
        "ln_f": _norm(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _dense(d, cfg.vocab_size)
    if cfg.frontend:
        specs["frontend"] = {"patch_proj": _dense(cfg.frontend_dim, d)}
    block = {"attn": _attn_block, "moe": lambda c, lead: _attn_block(c, lead, "moe"),
             "mamba2": _mamba2_block, "mlstm": _mlstm_block, "slstm": _slstm_block}
    specs["groups"] = [block[kind](cfg, (n,)) for kind, n in Model(cfg)._groups()]
    if cfg.shared_attn_every:
        specs["shared_attn"] = _attn_block(cfg)
    if cfg.enc_dec:
        specs["encoder"] = {"blocks": _attn_block(cfg, (cfg.n_encoder_layers,)),
                            "ln_f": _norm(d, cfg.norm)}
        specs["cross"] = {"ln": _norm(d, cfg.norm, (cfg.n_layers,)),
                          "attn": _gqa(cfg, (cfg.n_layers,))}
    if cfg.mtp_depth:
        specs["mtp"] = {"proj": _dense(2 * d, d), "block": _attn_block(cfg),
                        "ln": _norm(d, cfg.norm)}
    return specs


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig

    @property
    def model(self) -> Model:
        return Model(self.cfg)

    # ---- init --------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random weights drawn from ``generator`` (on its own device), each
        in its leaf's dtype on ``device``.  Every leaf is a fresh tensor that
        requires no grad, so training can mark it ``requires_grad_()``."""
        dev = resolve_device(device)
        dtype = torch_dtype(self.cfg)

        def make(leaf: Leaf):
            dt = leaf.dtype or dtype
            if leaf.init == "ones":
                return torch.ones(leaf.shape, dtype=dt, device=dev)
            if leaf.init == "zeros":
                return torch.zeros(leaf.shape, dtype=dt, device=dev)
            if leaf.init == "fill":
                vals = torch.tensor(leaf.values, dtype=dt, device=dev)
                return vals.expand(leaf.shape).clone()
            w = torch.randn(leaf.shape, generator=generator, device=generator.device)
            return w.mul_(leaf.scale).to(device=dev, dtype=dt)  # one f32 draw at a time

        return tree_map(make, param_specs(self.cfg))

    def param_shapes(self) -> Params:
        """The parameter tree on the ``meta`` device: shapes, no storage."""
        dtype = torch_dtype(self.cfg)
        return tree_map(
            lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype or dtype, device="meta"),
            param_specs(self.cfg),
        )

    def param_count(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.param_shapes()))

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only the routed-in experts count)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        shapes = self.param_shapes()
        expert_total = sum(t.numel() for g in shapes["groups"] if "moe" in g
                           for t in tree_leaves(g["moe"]["experts"]))
        active_frac = cfg.experts_per_token / cfg.n_experts
        return int(total - expert_total * (1 - active_frac))

    # ---- steps --------------------------------------------------------------
    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(total loss, metrics) of ``Model.loss``."""
        return self.model.loss(params, batch)

    def prefill_fn(
        self, params: Params, batch: Dict[str, torch.Tensor], max_len: int
    ) -> Tuple[torch.Tensor, Params]:
        """Full-sequence forward that returns logits + a filled cache (under
        a mesh, a cache of DTensors: ``sharding.distribute_cache``).  The
        logits are (B,S,V), or (B,K,V) at the positions of an optional
        "logit_positions" (B,K) entry of ``batch`` (``Model.forward``): the
        head then runs on those rows alone."""
        b, _ = batch["tokens"].shape
        enc_len = self.cfg.frontend_len if self.cfg.enc_dec else 0
        cache = self.model.init_cache(b, max_len, enc_len, device=batch["tokens"].device)
        ctx = sharding.current()
        if ctx is not None and not sharding.is_trivial(ctx["mesh"]):
            # under a mesh the cache is placed as decode finds it
            cache = sharding.distribute_cache(cache, ctx["mesh"], b)
        logits, cache, _ = self.model.forward(params, batch, cache=cache)
        return logits, cache

    def decode_fn(
        self,
        params: Params,
        cache: Params,
        tokens: torch.Tensor,  # (B, 1)
        index,  # scalar current position
    ) -> Tuple[torch.Tensor, Params]:
        b = tokens.shape[0]
        positions = torch.as_tensor(index, device=tokens.device).expand(b, 1)
        logits, cache, _ = self.model.forward(params, {"tokens": tokens}, cache=cache,
                                              positions=positions)
        return logits, cache

    # ---- input specs ----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` stand-ins for the step function's inputs, of the
        reference's shapes and dtypes: {"batch": {"tokens"[, "patch_embeds"
        (vit) | "frames" (enc_dec)]}} for train and prefill; {"cache",
        "tokens" (B, 1), "index" ()} for decode, the cache a ``meta``
        ``Model.init_cache`` of ``seq_len`` rows."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta, i32 = torch.device("meta"), torch.int32

        if shape.kind in ("train", "prefill"):
            batch: Dict[str, Any] = {"tokens": torch.empty((b, s), dtype=i32, device=meta)}
            extra = (cfg.frontend_len, cfg.frontend_dim)
            if cfg.frontend == "vit":
                batch["patch_embeds"] = torch.empty((b, *extra), dtype=torch_dtype(cfg),
                                                    device=meta)
            if cfg.enc_dec:
                batch["frames"] = torch.empty((b, *extra), dtype=torch_dtype(cfg), device=meta)
            return {"batch": batch}

        # decode: one new token against a cache of size seq_len
        enc_len = cfg.frontend_len if cfg.enc_dec else 0
        return {
            "cache": self.model.init_cache(b, s, enc_len, device=meta),
            "tokens": torch.empty((b, 1), dtype=i32, device=meta),
            "index": torch.empty((), dtype=i32, device=meta),
        }

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """long_500k requires sub-quadratic decode: a recurrent state or a
        sliding-window ring cache."""
        if shape.name == "long_500k":
            return self.cfg.supports_long_decode
        return True


def bundle(cfg: ArchConfig) -> ModelBundle:
    return ModelBundle(cfg)
