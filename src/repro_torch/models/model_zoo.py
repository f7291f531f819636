"""ArchConfig -> runnable model bundle: init / prefill / decode.
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

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .ssm import CONV_K, mamba_dims
from .transformer import Model, check_supported, torch_dtype

Params = Dict[str, Any]

__all__ = ["Leaf", "ModelBundle", "bundle", "param_specs"]


class Leaf(NamedTuple):
    """One parameter: its shape, initializer ("normal" with a scale, "ones"
    or "zeros") and dtype (None: the config's dtype)."""

    shape: Tuple[int, ...]
    init: str
    scale: Optional[float] = None
    dtype: Optional[torch.dtype] = None


def _dense(d_in: int, d_out: int, lead=()) -> Leaf:
    return Leaf(lead + (d_in, d_out), "normal", (1.0 / d_in) ** 0.5)


def _norm(d: int, kind: str, lead=()) -> Params:
    p = {"scale": Leaf(lead + (d,), "ones")}
    if kind == "layernorm":
        p["bias"] = Leaf(lead + (d,), "zeros")
    return p


def _attn_block(cfg: ArchConfig, lead=()) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    mlp = {"w_out": _dense(cfg.d_ff, d, lead)}
    if cfg.mlp == "swiglu":
        mlp["w_gate"] = _dense(d, cfg.d_ff, lead)
        mlp["w_up"] = _dense(d, cfg.d_ff, lead)
    else:
        mlp["w_in"] = _dense(d, cfg.d_ff, lead)
    return {
        "ln1": _norm(d, cfg.norm, lead),
        "ln2": _norm(d, cfg.norm, lead),
        "attn": {
            "wq": _dense(d, cfg.n_heads * hd, lead),
            "wk": _dense(d, cfg.n_kv_heads * hd, lead),
            "wv": _dense(d, cfg.n_kv_heads * hd, lead),
            "wo": _dense(cfg.n_heads * hd, d, lead),
        },
        "mlp": mlp,
    }


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


def param_specs(cfg: ArchConfig) -> Params:
    """The parameter tree with a ``Leaf`` per parameter; mirrors
    ``repro.models.transformer.Model.init`` (groups split as ``Model._groups``)."""
    specs: Params = {
        "embedding": Leaf((cfg.vocab_size, cfg.d_model), "normal", 0.02),
        "ln_f": _norm(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _dense(cfg.d_model, cfg.vocab_size)
    block = {"attn": _attn_block, "mamba2": _mamba2_block}
    specs["groups"] = [block[kind](cfg, (n,)) for kind, n in Model(cfg)._groups()]
    if cfg.shared_attn_every:
        specs["shared_attn"] = _attn_block(cfg)
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
        in its leaf's dtype on ``device``."""
        check_supported(self.cfg)
        dev = resolve_device(device)
        dtype = torch_dtype(self.cfg)

        def make(leaf: Leaf):
            dt = leaf.dtype or dtype
            if leaf.init == "ones":
                return torch.ones(leaf.shape, dtype=dt, device=dev)
            if leaf.init == "zeros":
                return torch.zeros(leaf.shape, dtype=dt, device=dev)
            w = torch.randn(leaf.shape, generator=generator, device=generator.device)
            return (w * leaf.scale).to(device=dev, dtype=dt)

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

    # ---- steps --------------------------------------------------------------
    def prefill_fn(
        self, params: Params, batch: Dict[str, torch.Tensor], max_len: int
    ) -> Tuple[torch.Tensor, Params]:
        """Full-sequence forward that returns logits + a filled cache."""
        b, _ = batch["tokens"].shape
        cache = self.model.init_cache(b, max_len, device=batch["tokens"].device)
        return self.model.forward(params, batch, cache=cache)

    def decode_fn(
        self,
        params: Params,
        cache: Params,
        tokens: torch.Tensor,  # (B, 1)
        index,  # scalar current position
    ) -> Tuple[torch.Tensor, Params]:
        b = tokens.shape[0]
        positions = torch.as_tensor(index, device=tokens.device).expand(b, 1)
        return self.model.forward(params, {"tokens": tokens}, cache=cache,
                                  positions=positions)


def bundle(cfg: ArchConfig) -> ModelBundle:
    return ModelBundle(cfg)
