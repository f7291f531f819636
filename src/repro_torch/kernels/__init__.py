"""Hand-written Hopper kernels for the served model's attention.

kernels:
  flash_attention  — prefill attention (GQA, causal, sliding window, Sq != Sk)
  decode_attention — flash-decoding, one token vs the KV cache (GQA packing)

Each is CUDA C++ under ``csrc/`` built for ``sm_90a`` at first use
(``_build.py``), with its plain PyTorch version in ``ref.py``; ``ops.py`` is the
dispatch the models call (kernel for CUDA tensors, plain version for CPU ones).
"""
from . import ops  # noqa: F401
