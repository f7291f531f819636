"""Zamba2-1.2B (Mamba2 backbone + shared attention block).  [arXiv:2411.15242]

38 Mamba2 layers; ONE weight-shared attention+MLP block is applied every 6
Mamba2 layers (simplified from Zamba2's concat-and-project re-entry; noted
in DESIGN.md).  ssm_state=64 per the assignment.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    mlp="gelu",
    norm="rmsnorm",
    block_pattern=("mamba2",),
    ssm_state=64,
    ssm_heads=32,
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_every=6,
)
