"""Flash-decoding: wrapper of ``csrc/decode_attention.cu``.

Counterpart of ``repro/kernels/decode_attention.py`` (``decode_attention_pallas``).
``decode_attention`` launches the CUDA kernel for a CUDA tensor and takes the
plain version (``ref.decode_attention_ref``) only for a CPU tensor.

The kernel splits each slot's cache into ``SPLIT``-row pieces, one block
each, and a second launch merges the pieces' partial softmax states; the
partials go to an f32 scratch tensor allocated here.  One call counts as
one ``decode_attention`` launch.  No training path reaches this kernel and it
has no backward (nor has the reference's): under autograd (grad enabled and
an input that requires grad) it raises.

A ``meta`` tensor (the static cost analysis) takes ``decode_attention_meta``: an
empty output of the kernel's shape and dtype, the launch's work
(``cost.decode_attention``, over the whole cache: a ``meta`` length has no value)
booked under ``decode_attention``, nothing launched and no plain version run.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import _build, cost
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_cuda", "decode_attention_meta", "NAME", "SPLIT"]

NAME = "decode_attention"
#: cache rows per block (the source note says why 64); read at each call
SPLIT = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _P],
}


def decode_attention_cuda(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, Smax, Hkv, D)
    v: torch.Tensor,  # (B, Smax, Hkv, Dv)
    length: Union[int, torch.Tensor],  # scalar or (B,); clamped to [0, Smax]
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, smax, hkv, _ = k.shape
    dv = v.shape[-1]
    if sq != 1:
        raise ValueError("decode_attention_cuda takes a single query token")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention_cuda: float32 or bfloat16 only, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or hq % hkv or d != k.shape[3]:
        raise ValueError(f"decode_attention_cuda: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d > 256 or dv > 256:
        raise ValueError("decode_attention_cuda: head dims above 256")
    _build.forbid_graph("decode_attention_cuda", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention_cuda: q, k, v must be contiguous")
    lengths = torch.as_tensor(length, device=q.device)
    if lengths.dim() > 1 or (lengths.dim() == 1 and lengths.shape[0] != b):
        raise ValueError(f"decode_attention_cuda: length must be a scalar or ({b},)")
    lengths = lengths.to(torch.int32).expand(b).contiguous()
    lib = _build.load(NAME, _SIGNATURES)
    out = torch.empty((b, 1, hq, dv), dtype=q.dtype, device=q.device)
    n_splits = -(-smax // SPLIT)
    scratch = torch.empty(b * hq * n_splits * (2 + dv), dtype=torch.float32, device=q.device)
    _build.launch(
        NAME, lib.decode_attention_fwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), _DTYPES[q.dtype], b, smax, hq, hkv, d, dv, SPLIT,
        1.0 / (d ** 0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def decode_attention_meta(q, k, v, length) -> torch.Tensor:
    """The kernel on ``meta`` tensors: books the launch's work over the whole
    cache, returns an empty (B, 1, Hq, Dv) output in q's dtype."""
    cost.book(NAME, cost.decode_attention(q, k, v))
    return torch.empty((*q.shape[:3], v.shape[-1]), dtype=q.dtype, device=q.device)


def decode_attention(q, k, v, length):
    """CUDA tensor: the hand-written kernel (or an error).  CPU tensor: the
    plain version.  ``meta`` tensor: the booked launch."""
    if q.is_cuda:
        return decode_attention_cuda(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length)
    if q.is_meta:
        return decode_attention_meta(q, k, v, length)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
