"""Copy reference weights into the port.

``params_to_torch`` takes the reference's parameter pytree with every leaf
already converted to a numpy array (the caller does that on its side, e.g.
with ``jax.tree.map(np.asarray, params)``) and returns the port's parameter
tree on ``device``.  Both trees share one layout, stacked per-group weights
with a leading L dimension and weights ``(d_in, d_out)``, so each leaf is a
plain copy: no transpose.  Every leaf of either tree must be matched with
the same shape, or this raises.  Each leaf takes its dtype from the port's
``param_specs`` (the config's dtype, or f32 for the f32 leaves of Mamba-2,
xLSTM and the MoE router); bf16 leaves go through float32, which is exact.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve_device
from .models.model_zoo import param_specs
from .models.transformer import torch_dtype

__all__ = ["params_to_torch"]


def params_to_torch(np_params: Dict[str, Any], cfg: ArchConfig, device="cuda"):
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    unmatched: List[str] = []

    def walk(spec, src, path: str):
        if isinstance(spec, dict):
            if not isinstance(src, dict):
                raise ValueError(f"{path}: expected a dict, got {type(src).__name__}")
            unmatched.extend(f"{path}/{k}" for k in src if k not in spec)
            return {k: walk(v, src[k] if k in src else None, f"{path}/{k}")
                    for k, v in spec.items()}
        if isinstance(spec, list):
            if not isinstance(src, (list, tuple)) or len(src) != len(spec):
                raise ValueError(f"{path}: expected a list of {len(spec)}")
            return [walk(v, s, f"{path}/{i}") for i, (v, s) in enumerate(zip(spec, src))]
        if src is None:
            raise ValueError(f"{path}: missing from the reference parameters")
        arr = np.asarray(src).astype(np.float32)  # exact for bf16 leaves
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape}, the port expects {spec.shape}")
        return torch.from_numpy(arr).to(device=dev, dtype=spec.dtype or dtype)

    out = walk(param_specs(cfg), np_params, "")
    if unmatched:
        raise ValueError(f"reference leaves the port does not map: {unmatched}")
    return out
