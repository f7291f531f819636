"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  Without a GPU the
caller must ask for the CPU explicitly: nothing falls back to it quietly.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
