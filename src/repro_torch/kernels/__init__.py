"""Hand-written Hopper kernels of the serving and training paths.

kernels:
  flash_attention     — prefill attention (GQA, causal, sliding window, Sq != Sk)
  decode_attention    — flash-decoding, one token vs the KV cache (GQA packing)
  decode_attention_q8 — the same over an int8 KV cache with per-(token, head) scales
  ssd_scan            — chunked Mamba-2 SSD scan (any sequence length)

Each is CUDA C++ under ``csrc/`` built for ``sm_90a`` at first use
(``_build.py``), with its plain PyTorch version in ``ref.py``; ``ops.py`` is the
dispatch the models call (kernel for CUDA tensors, plain version for CPU ones).
Under autograd, flash attention and the SSD scan go through
``torch.autograd.Function``s whose backward is plain PyTorch (``ref.py``).
A ``meta`` tensor takes each wrapper's ``meta`` route: an empty output of
the kernel's shape, nothing launched, and the launch's work (``cost.py``:
FLOPs and compulsory bytes from its shapes) booked with the static cost
analysis (``distribution/cost_analysis.py``).
"""
from . import ops  # noqa: F401
