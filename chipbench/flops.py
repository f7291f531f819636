"""Useful model FLOPs of a GQA decoder (dense SwiGLU or top-k MoE FFN,
optional patch frontend), counted from the configuration: what a token
needs, not what the program computes.

A token at position p (0-based) through one layer: the Q, K, V and output
projections, causal attention over the p + 1 keys it sees (QK^T and PV,
capped by a sliding window), and the FFN: SwiGLU's three matrices, or the
router and ``experts_per_token`` experts.  Then the LM head.  Padding,
experts run on empty capacity slots and logits nobody reads are not useful.
A multiply-add counts 2.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable


def _dims(c: Dict[str, Any]):
    d, h, kv = c["d_model"], c["n_heads"], c["n_kv_heads"]
    hd = c.get("head_dim") or d // h
    return d, h, kv, hd


def token_flops_but_attention(c: Dict[str, Any]) -> int:
    """One token through every layer's projections and FFN, and the head."""
    d, h, kv, hd = _dims(c)
    proj = 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d
    f, e = c["d_ff"], c.get("n_experts", 0)
    if e:
        ffn = 2 * d * e + c["experts_per_token"] * 3 * 2 * d * f
    else:
        ffn = 3 * 2 * d * f
    return c["n_layers"] * (proj + ffn) + 2 * d * c["vocab_size"]


def attention_flops(c: Dict[str, Any], position: int) -> int:
    """The attention of one token at ``position`` over every layer."""
    _, h, _, hd = _dims(c)
    keys = position + 1
    if c.get("sliding_window"):
        keys = min(keys, c["sliding_window"])
    return c["n_layers"] * 2 * h * keys * 2 * hd


def prefill_flops(c: Dict[str, Any], prompt_len: int, image: bool = False) -> int:
    """A prompt of ``prompt_len`` true tokens; with ``image``, the image's
    patch projection over the positions it covers too."""
    total = prompt_len * token_flops_but_attention(c)
    total += sum(attention_flops(c, p) for p in range(prompt_len))
    if image and c.get("frontend"):
        total += min(c["frontend_len"], prompt_len) * 2 * c["frontend_dim"] * c["d_model"]
    return total


def decode_flops(c: Dict[str, Any], positions: Iterable[int]) -> int:
    """One decode step: one token at each active slot's position."""
    per = token_flops_but_attention(c)
    return sum(per + attention_flops(c, p) for p in positions)
