"""Deterministic synthetic data pipeline.  Counterpart of
``repro/training/data.py``.

``get_batch(cfg, step)`` is a pure function of (config, step), which makes
the pipeline resumable after a failure: a resumed run consumes exactly the
batches a never-failed run would.  The token stream has learnable structure
(a noisy modular-affine sequence), so small models show a falling loss
within a few hundred steps.  The numpy draw is the reference's, call for
call, so the batches equal the reference's bit for bit, frontend inputs
included.  ``shard_batch`` places a batch on a mesh: every rank draws the
same global batch and keeps its own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DataConfig", "get_batch", "shard_batch"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: Optional[str] = None  # vit | audio
    frontend_len: int = 0
    frontend_dim: int = 0
    dtype: str = "bfloat16"


def get_batch(cfg: DataConfig, step: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Global batch for ``step`` on ``device``: int32 "tokens" (B, S) and, for
    a frontend, "patch_embeds" (vit) or "frames" (audio) (B, frontend_len,
    frontend_dim) in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    start = rng.integers(0, v, size=(b, 1))
    stride = rng.integers(1, 7, size=(b, 1))
    seq = (start + stride * np.arange(s)[None, :]) % v
    noise_mask = rng.random((b, s)) < 0.05
    noise = rng.integers(0, v, size=(b, s))
    tokens = np.where(noise_mask, noise, seq).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    if cfg.frontend in ("vit", "audio"):
        name = "patch_embeds" if cfg.frontend == "vit" else "frames"
        emb = rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim)) * 0.1
        # float64 rounded once to the dtype, as jnp.asarray(..., dtype=) does
        batch[name] = torch.from_numpy(emb).to(device=dev, dtype=_DTYPES[cfg.dtype])
    return batch


def shard_batch(batch: Dict[str, torch.Tensor], mesh, batch_axes=("pod", "data")):
    """The global ``batch`` (the same on every rank) as DTensors on ``mesh``,
    the batch dim sharded over ``batch_axes`` (those the mesh has): each rank
    keeps its own block of rows and nothing is sent.  On a mesh of one rank
    the batch comes back unchanged."""
    from ..distribution import sharding

    if sharding.is_trivial(mesh):
        return batch
    sizes = sharding.mesh_axes(mesh)
    axes = tuple(a for a in batch_axes if a in sizes)
    ways = 1
    for a in axes:
        ways *= sizes[a]
    entry = None if not axes else (axes[0] if len(axes) == 1 else axes)
    out = {}
    for k, x in batch.items():
        if x.shape[0] % ways:
            raise ValueError(f"shard_batch: {k} has {x.shape[0]} rows, not a multiple "
                             f"of the {ways} ranks of {axes}")
        out[k] = sharding.distribute(x, (entry,) + (None,) * (x.dim() - 1), mesh)
    return out
