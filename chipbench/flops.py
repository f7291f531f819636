"""Useful model FLOPs of the ``gqa`` kind (``chipbench/kinds/gqa.py``);
each kind counts its own, and a run reads its cell's kind's."""
from .kinds.gqa import attention_flops, decode_flops, prefill_flops, token_flops_but_attention

__all__ = ["token_flops_but_attention", "attention_flops", "prefill_flops", "decode_flops"]
