"""SmolLM-135M (llama-architecture small LM).  [hf:HuggingFaceTB/SmolLM-135M]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
