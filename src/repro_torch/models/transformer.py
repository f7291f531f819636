"""Decoder-only LM over dense GQA attention, Mamba-2 and xLSTM (mLSTM /
sLSTM) blocks, with Zamba2's weight-shared attention block: the trunk the
served replica runs.
Counterpart of ``repro/models/transformer.py``.

Layers of one kind are stacked with a leading L dimension, exactly as in the
reference's parameter and cache pytrees, so weights bridge over as plain
copies.  Hybrids split their runs at shared-attention boundaries, as the
reference does.  Where the reference runs ``jax.lax.scan`` over a stack,
this runs a Python loop over its rows.  The same ``forward`` serves three
modes:
  * no cache — full-sequence causal
  * prefill  — full-sequence causal, K/V and recurrent state written into
               the cache in place
  * decode   — one token per sequence against the cache, in place
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers, ssm

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ArchConfig) -> None:
    """The port covers dense GQA decoders, Mamba-2 hybrids with a shared
    attention block and xLSTM; everything else is still only in the
    reference package."""
    missing = []
    if cfg.attention != "gqa":
        missing.append(f"attention={cfg.attention}")
    if cfg.n_experts:
        missing.append("MoE")
    other = sorted(set(cfg.block_pattern) - {"attn", "mamba2", "mlstm", "slstm"})
    if other:
        missing.append(f"{'/'.join(other)} blocks")
    if cfg.enc_dec:
        missing.append("encoder-decoder")
    if cfg.frontend:
        missing.append(f"{cfg.frontend} frontend")
    if cfg.sliding_window:
        missing.append("sliding-window ring cache")
    if cfg.mtp_depth:
        missing.append("multi-token prediction")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet ({', '.join(missing)})"
        )


def _attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device, ragged: bool):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"index": torch.zeros((batch,) if ragged else (), dtype=torch.int32, device=device)}
    if layers.kv_quant_enabled():
        # int8 K/V + an f32 scale per (token, head); the port has no ring cache
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_s"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _block_cache(kind: str, cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                 ragged: bool):
    if kind == "attn":
        return {"attn": _attn_cache(cfg, batch, max_len, dtype, device, ragged)}
    if kind == "mlstm":
        return {"mixer": ssm.init_mlstm_state(cfg, batch, device)}
    if kind == "slstm":
        return {"mixer": ssm.init_slstm_state(cfg, batch, device)}
    return {"mixer": ssm.init_mamba_state(cfg, batch, dtype, device)}


def _stack(n: int, tree):
    if isinstance(tree, dict):
        return {k: _stack(n, v) for k, v in tree.items()}
    return tree.expand((n,) + tree.shape).clone()


def _layer(tree, i: int):
    """Row i of a stacked tree: views, so in-place cache writes land in the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(p: Params, x: torch.Tensor, kind: str, cfg: ArchConfig, positions, cache):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    if kind != "attn":  # recurrent mixers
        fn = {"mamba2": ssm.mamba2_block, "mlstm": ssm.mlstm_block,
              "slstm": ssm.slstm_block}[kind]
        y, _ = fn(p["mixer"], h, cfg, cache["mixer"] if cache is not None else None)
        return x + y
    x = x + layers.attention(p["attn"], h, cfg, positions,
                             cache["attn"] if cache is not None else None)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        check_supported(self.cfg)

    def _groups(self) -> Tuple[Tuple[str, int], ...]:
        """Layer runs, split at shared-attention boundaries for hybrids: the
        stacking of the reference's parameter and cache trees."""
        cfg = self.cfg
        runs = cfg.layer_groups()
        if not cfg.shared_attn_every:
            return runs
        out: List[Tuple[str, int]] = []
        for kind, count in runs:
            while count > 0:
                take = min(cfg.shared_attn_every, count)
                out.append((kind, take))
                count -= take
        return tuple(out)

    @property
    def n_shared_apps(self) -> int:
        """How many times the shared attention block is applied."""
        cfg = self.cfg
        return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0

    # ---- cache init --------------------------------------------------------
    def init_cache(
        self, batch: int, max_len: int, ragged: bool = False, device="cuda"
    ) -> Params:
        """ragged=True gives every batch slot its own cache index — the
        continuous-batching decode state used by serving/engine.py."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        cache: Params = {
            "groups": [_stack(count, _block_cache(kind, cfg, batch, max_len, dtype, dev, ragged))
                       for kind, count in self._groups()]
        }
        if cfg.shared_attn_every:
            cache["shared"] = _stack(
                self.n_shared_apps, _block_cache("attn", cfg, batch, max_len, dtype, dev, ragged))
        return cache

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
        done, shared_ct = 0, 0
        for gi, (kind, count) in enumerate(self._groups()):
            gp = params["groups"][gi]
            gc = cache["groups"][gi] if cache is not None else None
            for i in range(count):
                x = _apply_block(_layer(gp, i), x, kind, cfg, positions,
                                 _layer(gc, i) if gc is not None else None)
            done += count
            if (cfg.shared_attn_every and done % cfg.shared_attn_every == 0
                    and shared_ct < self.n_shared_apps):
                sc = _layer(cache["shared"], shared_ct) if cache is not None else None
                x = _apply_block(params["shared_attn"], x, "attn", cfg, positions, sc)
                shared_ct += 1
        x = layers.apply_norm(params["ln_f"], x, cfg.norm)
        head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
        return layers.lm_logits(head, x, cfg.tie_embeddings), cache
