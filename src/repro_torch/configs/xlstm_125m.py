"""xLSTM-125M (sLSTM + mLSTM blocks, d_ff=0: projection-factor FFNs inside
the blocks).  [arXiv:2405.04517]

Block ratio approximates the paper's mLSTM-heavy mixes: every 4th block is
an sLSTM, the rest are mLSTM.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    norm="layernorm",
    rope_mode="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_chunk=256,
)
