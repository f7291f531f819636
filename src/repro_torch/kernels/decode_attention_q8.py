"""Flash-decoding over an int8 KV cache: wrapper of ``csrc/decode_attention_q8.cu``.

Counterpart of ``repro/kernels/decode_attention.py`` (``decode_attention_q8_pallas``).
``decode_attention_q8`` launches the CUDA kernel for a CUDA tensor and takes
the plain version (``ref.decode_attention_q8_ref``) only for a CPU tensor.

The design is the bf16 decode's split-K: the kernel splits each slot's cache
into ``SPLIT``-row pieces, one block each, and the bf16 decode's combine
kernel merges the pieces' partial softmax states from an f32 scratch tensor
allocated here.  One call counts as one ``decode_attention_q8`` launch.  No
training path reaches this kernel and it has no backward (nor has the
reference's): under autograd (grad enabled and an input that requires grad)
it raises.

A ``meta`` tensor (the static cost analysis) takes
``decode_attention_q8_meta``: an empty output of the kernel's shape and
dtype, the launch's work (``cost.decode_attention_q8``, over the whole
cache: a ``meta`` length has no value) booked under
``decode_attention_q8``, nothing launched and no plain version run.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import _build, cost
from .ref import decode_attention_q8_ref

__all__ = ["decode_attention_q8", "decode_attention_q8_cuda", "decode_attention_q8_meta", "NAME",
           "SPLIT"]

NAME = "decode_attention_q8"
#: cache rows per block (the source note says why 64); read at each call
SPLIT = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "decode_attention_q8_fwd": [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P],
}


def decode_attention_q8_cuda(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k_q: torch.Tensor,  # (B, Smax, Hkv, D) int8
    k_s: torch.Tensor,  # (B, Smax, Hkv) f32
    v_q: torch.Tensor,  # (B, Smax, Hkv, Dv) int8
    v_s: torch.Tensor,  # (B, Smax, Hkv) f32
    length: Union[int, torch.Tensor],  # scalar or (B,); clamped to [0, Smax]
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, smax, hkv, _ = k_q.shape
    dv = v_q.shape[-1]
    tensors = (k_q, k_s, v_q, v_s)
    if sq != 1:
        raise ValueError("decode_attention_q8_cuda takes a single query token")
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("decode_attention_q8_cuda: every input must be on one CUDA device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention_q8_cuda: q float32 or bfloat16, got {q.dtype}")
    if (k_q.dtype, v_q.dtype, k_s.dtype, v_s.dtype) != (torch.int8,) * 2 + (torch.float32,) * 2:
        raise TypeError("decode_attention_q8_cuda: k/v int8 and their scales float32, got "
                        f"{k_q.dtype}/{v_q.dtype}/{k_s.dtype}/{v_s.dtype}")
    if (k_q.shape[0] != b or v_q.shape[:3] != k_q.shape[:3] or hq % hkv or d != k_q.shape[3]
            or k_s.shape != k_q.shape[:3] or v_s.shape != k_q.shape[:3]):
        raise ValueError(f"decode_attention_q8_cuda: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_q.shape)} k_s{tuple(k_s.shape)} v{tuple(v_q.shape)} "
                         f"v_s{tuple(v_s.shape)}")
    if d > 256 or dv > 256:
        raise ValueError("decode_attention_q8_cuda: head dims above 256")
    _build.forbid_graph("decode_attention_q8_cuda", q, *tensors)
    if not (q.is_contiguous() and all(t.is_contiguous() for t in tensors)):
        raise ValueError("decode_attention_q8_cuda: every input must be contiguous")
    lengths = torch.as_tensor(length, device=q.device)
    if lengths.dim() > 1 or (lengths.dim() == 1 and lengths.shape[0] != b):
        raise ValueError(f"decode_attention_q8_cuda: length must be a scalar or ({b},)")
    lengths = lengths.to(torch.int32).expand(b).contiguous()
    lib = _build.load(NAME, _SIGNATURES)
    out = torch.empty((b, 1, hq, dv), dtype=q.dtype, device=q.device)
    n_splits = -(-smax // SPLIT)
    scratch = torch.empty(b * hq * n_splits * (2 + dv), dtype=torch.float32, device=q.device)
    _build.launch(
        NAME, lib.decode_attention_q8_fwd,
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), _DTYPES[q.dtype], b, smax, hq,
        hkv, d, dv, SPLIT, 1.0 / (d ** 0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def decode_attention_q8_meta(q, k_q, k_s, v_q, v_s, length) -> torch.Tensor:
    """The kernel on ``meta`` tensors: books the launch's work over the whole
    cache, returns an empty (B, 1, Hq, Dv) output in q's dtype."""
    cost.book(NAME, cost.decode_attention_q8(q, k_q, k_s, v_q, v_s))
    return torch.empty((*q.shape[:3], v_q.shape[-1]), dtype=q.dtype, device=q.device)


def decode_attention_q8(q, k_q, k_s, v_q, v_s, length):
    """CUDA tensor: the hand-written kernel (or an error).  CPU tensor: the
    plain version.  ``meta`` tensor: the booked launch."""
    if q.is_cuda:
        return decode_attention_q8_cuda(q, k_q, k_s, v_q, v_s, length)
    if q.device.type == "cpu":
        return decode_attention_q8_ref(q, k_q, k_s, v_q, v_s, length)
    if q.is_meta:
        return decode_attention_q8_meta(q, k_q, k_s, v_q, v_s, length)
    raise ValueError(f"decode_attention_q8: unsupported device {q.device}")
