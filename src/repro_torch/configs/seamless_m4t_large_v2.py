"""SeamlessM4T-large-v2 text backbone (encoder-decoder).  [arXiv:2308.11596]

The speech/audio frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (B, n_frames, d_model) consumed by the encoder; the decoder
is a standard transformer with cross-attention.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    n_encoder_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    rope_mode="none",  # learned/sinusoidal positions; stub uses none
    frontend="audio",
    frontend_dim=1024,
    frontend_len=1024,  # precomputed speech frames per sample
)
