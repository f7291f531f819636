"""Pixtral-12B (pixtral-ViT frontend stub + mistral-nemo-like backbone).
[hf:mistralai/Pixtral-12B-2409]

The ViT frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, n_patches, 1024) that the backbone projects
into d_model and splices over the leading token positions.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    frontend="vit",
    frontend_dim=1024,  # pixtral ViT width
    frontend_len=256,  # patches per image (16x16 grid stub)
)
