"""Flash attention forward (prefill): wrapper of ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``).
``flash_attention`` launches the CUDA kernel for a CUDA tensor and takes the
plain version (``ref.attention_ref``) only for a CPU tensor.

The source has two bodies and ``body`` picks one by shape, before the
launch: the tensor-core body for bf16 with both head dims multiples of 16
(16-byte aligned tensors), the CUDA-core body for everything else (f32,
which the tensor cores cannot keep to 2e-5, and odd bf16 head dims).  Every
launch counts under ``flash_attention`` and under its body's own counter,
``flash_attention.tc`` or ``flash_attention.simt``.

Under autograd (grad enabled and an input that requires grad) a CUDA tensor
goes through ``FlashAttention``, a ``torch.autograd.Function``: its forward
is the same kernel launch, its backward the plain query-chunked recompute
``ref.attention_bwd_ref`` (the reference has no backward kernel either; it
differentiates its chunked jnp attention).  ``flash_attention_cuda`` itself
never builds a graph, so it raises when called directly under autograd.

A ``meta`` tensor (the static cost analysis) takes ``flash_attention_meta``:
an empty output of the kernel's shape and dtype, the launch's work
(``cost.flash_attention``) booked under ``flash_attention``, nothing
launched and no plain version run.  Under autograd it goes through
``FlashAttention`` too, whose backward then runs the plain backward on
``meta`` tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, cost
from .ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_meta", "FlashAttention",
           "body", "NAME"]

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _P],
    "flash_attention_tc_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
}


def body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` (tensor cores) for bf16 with D % 16 == 0, Dv % 16 == 0 and
    16-byte aligned q/k/v; ``"simt"`` (CUDA cores) for everything else."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if q.dtype == torch.bfloat16 and q.shape[-1] % 16 == 0 and v.shape[-1] % 16 == 0 and aligned:
        return "tc"
    return "simt"


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: float32 or bfloat16 only, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or hq % hkv or d != k.shape[3]:
        raise ValueError(f"flash_attention_cuda: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d > 256 or dv > 256:
        raise ValueError("flash_attention_cuda: head dims above 256")
    _build.forbid_graph("flash_attention_cuda", q, k, v)
    if causal and sq > sk:
        raise ValueError("flash_attention_cuda: causal with Sq > Sk leaves query rows "
                         "with no visible key")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError("flash_attention_cuda: sliding_window must be >= 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    lib = _build.load(NAME, _SIGNATURES)
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (b, sq, sk, hq, hkv, d, dv, int(causal), int(sliding_window or 0), 1.0 / (d ** 0.5))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if body(q, k, v) == "tc":
        _build.launch((NAME, NAME + ".tc"), lib.flash_attention_tc_fwd, *ptrs, *shape, stream)
    else:
        _build.launch((NAME, NAME + ".simt"), lib.flash_attention_fwd, *ptrs,
                      _DTYPES[q.dtype], *shape, stream)
    return out


def flash_attention_meta(q, k, v, causal: bool = True,
                         sliding_window: Optional[int] = None) -> torch.Tensor:
    """The kernel on ``meta`` tensors: books the launch's work, returns an
    empty (B, Sq, Hq, Dv) output in q's dtype."""
    cost.book(NAME, cost.flash_attention(q, k, v, causal, sliding_window))
    return torch.empty((*q.shape[:3], v.shape[-1]), dtype=q.dtype, device=q.device)


class FlashAttention(torch.autograd.Function):
    """Forward: ``flash_attention_cuda`` on a CUDA tensor,
    ``flash_attention_meta`` on a ``meta`` one (``attention_ref`` on a CPU
    one, which the CPU tests use to check this backward).  Backward:
    ``attention_bwd_ref``, which recomputes the probabilities chunk by chunk
    from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sliding_window: Optional[int]):
        if q.is_cuda:
            out = flash_attention_cuda(q, k, v, causal, sliding_window)
        elif q.is_meta:
            out = flash_attention_meta(q, k, v, causal, sliding_window)
        else:
            out = attention_ref(q, k, v, causal, sliding_window)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd_ref(q, k, v, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, sliding_window: Optional[int] = None):
    """CUDA tensor: the hand-written kernel (or an error), through
    ``FlashAttention`` under autograd.  CPU tensor: the plain version.
    ``meta`` tensor: the booked launch, through ``FlashAttention`` under
    autograd."""
    if q.is_cuda or q.is_meta:
        if _build.wants_graph(q, k, v):
            return FlashAttention.apply(q, k, v, causal, sliding_window)
        if q.is_meta:
            return flash_attention_meta(q, k, v, causal, sliding_window)
        return flash_attention_cuda(q, k, v, causal, sliding_window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, sliding_window)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
