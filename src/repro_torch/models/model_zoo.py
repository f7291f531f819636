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
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .transformer import Model, check_supported, torch_dtype

Params = Dict[str, Any]

__all__ = ["ModelBundle", "bundle", "param_specs"]


def _dense(d_in: int, d_out: int, lead=()):
    return (lead + (d_in, d_out), ("normal", (1.0 / d_in) ** 0.5))


def param_specs(cfg: ArchConfig) -> Params:
    """The parameter tree as (shape, (init, scale)) leaves, init in
    {"normal", "ones", "zeros"}; mirrors ``repro.models.transformer.Model.init``."""
    d, hd = cfg.d_model, cfg.head_dim_
    specs: Params = {
        "embedding": ((cfg.vocab_size, d), ("normal", 0.02)),
        "ln_f": {"scale": ((d,), ("ones", None))},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _dense(d, cfg.vocab_size)
    groups = []
    for _, n in cfg.layer_groups():
        lead = (n,)
        norm = {"scale": (lead + (d,), ("ones", None))}
        if cfg.norm == "layernorm":
            norm["bias"] = (lead + (d,), ("zeros", None))
        mlp = {"w_out": _dense(cfg.d_ff, d, lead)}
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = _dense(d, cfg.d_ff, lead)
            mlp["w_up"] = _dense(d, cfg.d_ff, lead)
        else:
            mlp["w_in"] = _dense(d, cfg.d_ff, lead)
        groups.append({
            "ln1": dict(norm),
            "ln2": dict(norm),
            "attn": {
                "wq": _dense(d, cfg.n_heads * hd, lead),
                "wk": _dense(d, cfg.n_kv_heads * hd, lead),
                "wv": _dense(d, cfg.n_kv_heads * hd, lead),
                "wo": _dense(cfg.n_heads * hd, d, lead),
            },
            "mlp": mlp,
        })
    specs["groups"] = groups
    if cfg.norm == "layernorm":
        specs["ln_f"]["bias"] = ((d,), ("zeros", None))
    return specs


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig

    @property
    def model(self) -> Model:
        return Model(self.cfg)

    # ---- init --------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random weights drawn from ``generator`` (on its own device), in the
        config's dtype on ``device``."""
        check_supported(self.cfg)
        dev = resolve_device(device)
        dtype = torch_dtype(self.cfg)

        def make(shape, init):
            kind, scale = init
            if kind == "ones":
                return torch.ones(shape, dtype=dtype, device=dev)
            if kind == "zeros":
                return torch.zeros(shape, dtype=dtype, device=dev)
            w = torch.randn(shape, generator=generator, device=generator.device)
            return (w * scale).to(device=dev, dtype=dtype)

        return tree_map(lambda spec: make(*spec), param_specs(self.cfg))

    def param_shapes(self) -> Params:
        """The parameter tree on the ``meta`` device: shapes, no storage."""
        dtype = torch_dtype(self.cfg)
        return tree_map(
            lambda spec: torch.empty(spec[0], dtype=dtype, device="meta"),
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
