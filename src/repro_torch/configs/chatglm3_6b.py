"""ChatGLM3-6B (GQA kv=2, half-rotary 2d RoPE).  [arXiv:2406.12793]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_mode="half",  # ChatGLM applies rotary to half the head dims (2d RoPE)
)
