"""PyTorch/CUDA port of the serving stack in ``repro``.

The port mirrors the reference package's module names (``configs``,
``kernels``, ``models``, ``serving``, ``launch``) so each module has an
obvious counterpart.  It imports torch and numpy only: never ``jax`` and never
``repro``; what it needs from the reference's pure-data modules it keeps as
its own copy.  Its kernels (prefill and decode attention, decode attention
over an int8 cache, the Mamba-2 SSD scan) are CUDA C++ written for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
