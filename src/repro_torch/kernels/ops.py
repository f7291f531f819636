"""Kernel dispatch: one call site for the model code.

Counterpart of ``repro/kernels/ops.py``.  There is no global switch: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes the
plain version.  No ``try`` falls back from one to the other.  Under autograd
a CUDA tensor's flash attention and SSD scan go through their
``torch.autograd.Function`` (the kernel forward, a plain backward); the
decode kernels raise there.  Every kernel keeps an integer launch count,
read with ``launch_counts()``.
"""
from __future__ import annotations

import torch

from ._build import launch_counts, reset_launch_counts
from .decode_attention import decode_attention
from .decode_attention_q8 import decode_attention_q8
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan

__all__ = [
    "flash_attention", "decode_attention", "decode_attention_q8", "cross_attention",
    "ssd_scan", "launch_counts", "reset_launch_counts",
]


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention(q, k, v, causal=False, sliding_window=None)
