"""Decoder-only dense LM: the trunk the served replica runs.
Counterpart of ``repro/models/transformer.py``.

Layers of one kind are stacked with a leading L dimension, exactly as in the
reference's parameter and cache pytrees, so weights bridge over as plain
copies.  Where the reference runs ``jax.lax.scan`` over the stack, this runs
a Python loop over its rows.  The same ``forward`` serves three modes:
  * no cache — full-sequence causal
  * prefill  — full-sequence causal, K/V written into the cache in place
  * decode   — one token per sequence against the cache, in place
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ArchConfig) -> None:
    """The port covers the dense GQA decoder; everything else is still only
    in the reference package."""
    missing = []
    if cfg.attention != "gqa":
        missing.append(f"attention={cfg.attention}")
    if cfg.n_experts:
        missing.append("MoE")
    if cfg.is_recurrent:
        missing.append("recurrent blocks")
    if cfg.enc_dec:
        missing.append("encoder-decoder")
    if cfg.frontend:
        missing.append(f"{cfg.frontend} frontend")
    if cfg.shared_attn_every:
        missing.append("shared attention")
    if cfg.sliding_window:
        missing.append("sliding-window ring cache")
    if cfg.mtp_depth:
        missing.append("multi-token prediction")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet ({', '.join(missing)})"
        )


def _block_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device, ragged: bool):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((batch,) if ragged else (), dtype=torch.int32, device=device),
    }


def _stack(n: int, tree):
    if isinstance(tree, dict):
        return {k: _stack(n, v) for k, v in tree.items()}
    return tree.expand((n,) + tree.shape).clone()


def _layer(tree, i: int):
    """Row i of a stacked tree: views, so in-place cache writes land in the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(p: Params, x: torch.Tensor, cfg: ArchConfig, positions, cache):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    x = x + layers.attention(p["attn"], h, cfg, positions,
                             cache["attn"] if cache is not None else None)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        check_supported(self.cfg)

    # ---- cache init --------------------------------------------------------
    def init_cache(
        self, batch: int, max_len: int, ragged: bool = False, device="cuda"
    ) -> Params:
        """ragged=True gives every batch slot its own cache index — the
        continuous-batching decode state used by serving/engine.py."""
        cfg = self.cfg
        dev = resolve_device(device)
        block = _block_cache(cfg, batch, max_len, torch_dtype(cfg), dev, ragged)
        return {
            "groups": [_stack(count, {"attn": block}) for _, count in cfg.layer_groups()]
        }

    # ---- public entry point ------------------------------------------------
    def forward(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        cache: Optional[Params] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[Params]]:
        """Returns (f32 logits (B,S,V), cache).  The cache is updated in place
        and returned for symmetry with the reference's functional API."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = layers.embed(params["embedding"], tokens)
        for gi, (_, count) in enumerate(cfg.layer_groups()):
            gp = params["groups"][gi]
            gc = cache["groups"][gi] if cache is not None else None
            for i in range(count):
                x = _apply_block(_layer(gp, i), x, cfg, positions,
                                 _layer(gc, i) if gc is not None else None)
        x = layers.apply_norm(params["ln_f"], x, cfg.norm)
        head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
        return layers.lm_logits(head, x, cfg.tie_embeddings), cache
