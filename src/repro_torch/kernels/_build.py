"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
the checkout's ``build/`` directory and loaded with ``ctypes``; the library's
file name carries a hash of the flags, the source and every ``csrc/`` header
it includes, so an edited source or header is rebuilt and a stale library is
never loaded.  Nothing here runs at import time:
the CPU tests import every module without a CUDA toolkit.

``launch`` is the one place a kernel is started.  It counts the launch and
raises if the C side reports a CUDA error, so a refused launch never passes
silently.  A kernel writes into a fresh tensor that autograd knows nothing
of: ``forbid_graph`` makes a ``*_cuda`` wrapper raise where its caller would
want a gradient, and ``wants_graph`` routes such a call through the
kernel's ``torch.autograd.Function`` where it has one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import torch

__all__ = [
    "CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "launch",
    "launch_counts", "reset_launch_counts", "wants_graph", "forbid_graph",
]

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<checkout>/build`` (listed in .gitignore): src/repro_torch/kernels -> root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen: Optional[List[Path]] = None) -> List[Path]:
    """``path`` and every header under ``csrc/`` it includes, transitively."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        header = path.parent / inc.decode()
        if header.exists():
            _sources(header, seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, all ``nvcc``
    processes started together.  Returns seconds per compiled kernel and
    writes each compiler log (``-Xptxas -v``: registers, shared memory,
    spills) beside its library."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    t0 = time.perf_counter()
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds: Dict[str, float] = {}
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps each
    exported C function to its ``argtypes``.  Every function returns the
    ``cudaError_t`` of its launch as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(counters: Union[str, Sequence[str]], fn, *args) -> None:
    """Call one exported launcher, add one to each of its counters and raise
    on a CUDA error."""
    names = (counters,) if isinstance(counters, str) else tuple(counters)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{names[0]} kernel launch failed: cudaError_t {rc}")
    for name in names:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def wants_graph(*tensors) -> bool:
    """Grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def forbid_graph(name: str, *tensors) -> None:
    """Raise where a kernel's output would silently cut the autograd graph."""
    if wants_graph(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward here; an input requires grad "
            "under grad mode (call it under torch.no_grad(), or through its "
            "autograd Function where it has one)")


def launch_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    _COUNTS.clear()
