"""DeepSeek-V3 (671B MoE: MLA, 1 shared + 256 routed top-8, MTP).  [arXiv:2412.19437]

d_ff=2048 is the routed-expert hidden dim; the 3 leading dense layers use
the model's dense FFN width 18432.  MLA dims per the paper: q_lora 1536,
kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense-layer FFN width
    moe_d_ff=2048,  # routed/shared expert hidden dim
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    n_dense_layers=3,
    mtp_depth=1,
)
