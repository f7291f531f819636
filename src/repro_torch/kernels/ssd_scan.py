"""Chunked Mamba-2 SSD scan: wrapper of ``csrc/ssd_scan.cu``.

Counterpart of ``repro/kernels/ssd_scan.py`` (``ssd_scan_pallas``).
``ssd_scan`` launches the CUDA kernel for a CUDA tensor and takes the plain
version (``ref.ssd_scan_ref``) only for a CPU tensor.  The kernel picks its
own time tile (64 steps) and takes any sequence length.

The source has two bodies and ``body`` picks one by shape, before the
launch: the tensor-core body (three chunk-parallel launches, plainly
``ref.ssd_chunk_states_ref``, ``ref.ssd_state_passing_ref`` and
``ref.ssd_chunk_scan_ref``; its f32 scratch is allocated here) for bf16 with
P and N multiples of 16, P <= 256 and 16-byte aligned rows, the CUDA-core
body for everything else (f32, which the tensor cores cannot keep to 5e-5,
and other bf16 shapes).  Every call counts under ``ssd_scan`` and under its
body's own counter, ``ssd_scan.tc`` or ``ssd_scan.simt``.

Under autograd (grad enabled and an input that requires grad) a CUDA tensor
goes through ``SSDScan``, a ``torch.autograd.Function``: its forward is the
same kernel launch, its backward ``ref.ssd_scan_bwd_ref``, the plain
recurrence recomputed under autograd in its chunk-parallel form (the
reference has no backward kernel; it differentiates its chunked jnp scan).
``ssd_scan_cuda`` itself never builds a graph, so it raises when called
directly under autograd.

A ``meta`` tensor (the static cost analysis) takes ``ssd_scan_meta``: empty
outputs of the kernel's shapes and dtypes (y, the f32 final state), the
launch's work (``cost.ssd_scan``) booked under ``ssd_scan``, nothing
launched and no plain version run.  Under autograd it goes through
``SSDScan`` too, whose backward then runs the plain backward on ``meta``
tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, cost
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_cuda", "ssd_scan_meta", "SSDScan", "body", "NAME", "CHUNK"]

NAME = "ssd_scan"
#: the kernel's time tile (``L`` in csrc/ssd_scan.cu); sizes the tensor-core body's scratch
CHUNK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ssd_scan_fwd": [_P] * 8 + [_I] * 6 + [_L] * 6 + [_P],
    "ssd_scan_tc_fwd": [_P] * 9 + [_I] * 5 + [_L] * 6 + [_P],
}
_MAX_N = 128
_TC_MAX_P = 256  # x and h_enter tiles of one head fit in shared memory


def body(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> str:
    """``"tc"`` (tensor cores) for bf16 with P % 16 == 0, P <= 256,
    N % 16 == 0, and x, B, C whose base pointers and batch and sequence
    strides are 16-byte aligned; ``"simt"`` (CUDA cores) for everything
    else."""
    p, n = x.shape[-1], B.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                  for t in (x, B, C))
    if (x.dtype == torch.bfloat16 and p % 16 == 0 and p <= _TC_MAX_P and n % 16 == 0
            and aligned):
        return "tc"
    return "simt"


def ssd_scan_cuda(
    x: torch.Tensor,  # (Bt, S, H, P); (H, P) contiguous, any batch/sequence strides
    dt: torch.Tensor,  # (Bt, S, H) f32, contiguous
    A: torch.Tensor,  # (H,) f32
    B: torch.Tensor,  # (Bt, S, N); N contiguous
    C: torch.Tensor,  # (Bt, S, N); N contiguous
    initial_state: Optional[torch.Tensor] = None,  # (Bt, H, P, N) f32, contiguous
):
    """Returns y (Bt, S, H, P) in x's dtype and the final state (Bt, H, P, N) f32.
    Raises on a layout the kernel does not take; never copies to make one."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    tensors = [x, dt, A, B, C] + ([initial_state] if initial_state is not None else [])
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd_scan_cuda: every input must be on one CUDA device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan_cuda: x, B, C float32 or bfloat16 alike, got "
                        f"{x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan_cuda: dt and A must be float32, got {dt.dtype}/{A.dtype}")
    if (dt.shape != (bt, s, h) or A.shape != (h,) or B.shape != (bt, s, n)
            or C.shape != (bt, s, n)):
        raise ValueError(f"ssd_scan_cuda: bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"A{tuple(A.shape)} B{tuple(B.shape)} C{tuple(C.shape)}")
    if not 0 < n <= _MAX_N:
        raise ValueError(f"ssd_scan_cuda: state size N={n} outside (0, {_MAX_N}]")
    _build.forbid_graph("ssd_scan_cuda", *tensors)
    # an empty sequence reads nothing, whatever strides it carries
    if s > 0 and (x.stride(3) != 1 or x.stride(2) != p):
        raise ValueError("ssd_scan_cuda: x needs contiguous (H, P) rows")
    if s > 0 and (B.stride(2) != 1 or C.stride(2) != 1):
        raise ValueError("ssd_scan_cuda: B and C need contiguous N")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_scan_cuda: dt and A must be contiguous")
    if initial_state is not None:
        if initial_state.dtype != torch.float32 or initial_state.shape != (bt, h, p, n):
            raise ValueError(f"ssd_scan_cuda: initial_state must be float32 {(bt, h, p, n)}, "
                             f"got {initial_state.dtype} {tuple(initial_state.shape)}")
        if not initial_state.is_contiguous():
            raise ValueError("ssd_scan_cuda: initial_state must be contiguous")
    lib = _build.load(NAME, _SIGNATURES)
    y = torch.empty((bt, s, h, p), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            y.data_ptr(), h_t.data_ptr())
    shape = (bt, s, h, p, n, x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0),
             C.stride(1), torch.cuda.current_stream(x.device).cuda_stream)
    if body(x, B, C) == "tc":
        # the chunks' own states, then the states entering them, and each
        # chunk's total log-decay
        n_chunks = -(-s // CHUNK)
        scratch = torch.empty(bt * n_chunks * h * (p * n + 1), dtype=torch.float32,
                              device=x.device)
        _build.launch((NAME, NAME + ".tc"), lib.ssd_scan_tc_fwd, *ptrs, scratch.data_ptr(),
                      *shape)
    else:
        _build.launch((NAME, NAME + ".simt"), lib.ssd_scan_fwd, *ptrs, _DTYPES[x.dtype],
                      *shape)
    return y, h_t


def ssd_scan_meta(x, dt, A, B, C, initial_state=None):
    """The kernel on ``meta`` tensors: books the launch's work, returns empty
    y (Bt, S, H, P) in x's dtype and the final state (Bt, H, P, N) f32."""
    bt, _, h, p = x.shape
    cost.book(NAME, cost.ssd_scan(x, dt, A, B, C, initial_state))
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((bt, h, p, B.shape[-1]), dtype=torch.float32, device=x.device))


class SSDScan(torch.autograd.Function):
    """Forward: ``ssd_scan_cuda`` on a CUDA tensor, ``ssd_scan_meta`` on a
    ``meta`` one (``ssd_scan_ref`` on a CPU one, which the CPU tests use to
    check this backward), on the inputs as given, strided views included.
    Backward: ``ssd_scan_bwd_ref`` from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state):
        fn = ssd_scan_cuda if x.is_cuda else ssd_scan_meta if x.is_meta else ssd_scan_ref
        y, final = fn(x, dt, A, B, C, initial_state)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        return ssd_scan_bwd_ref(*ctx.saved_tensors, dy, dfinal, ctx.needs_input_grad)


def ssd_scan(x, dt, A, B, C, initial_state=None):
    """CUDA tensor: the hand-written kernel (or an error), through ``SSDScan``
    under autograd.  CPU tensor: the plain version.  ``meta`` tensor: the
    booked launch, through ``SSDScan`` under autograd."""
    if x.is_cuda or x.is_meta:
        if _build.wants_graph(x, dt, A, B, C, initial_state):
            return SSDScan.apply(x, dt, A, B, C, initial_state)
        if x.is_meta:
            return ssd_scan_meta(x, dt, A, B, C, initial_state)
        return ssd_scan_cuda(x, dt, A, B, C, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, initial_state)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")
