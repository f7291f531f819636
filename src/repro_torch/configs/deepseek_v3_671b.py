"""DeepSeek-V3 (671B MoE: MLA, 1 shared + 256 routed top-8, MTP).  [arXiv:2412.19437]

d_ff=2048 is the routed-expert hidden dim; the 3 leading dense layers use
the model's dense FFN width 18432.  MLA dims per the paper: q_lora 1536,
kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.

``CONFIG`` is the reference package's approximation (a softmax top-k
router with capacity drops, plain RoPE, eps 1e-5), held to it by the
parity tests.  ``PUBLISHED`` is the model as its config.json states it
(hf ``deepseek-ai/DeepSeek-V3``): the ``noaux_tc`` router (sigmoid scores,
a choice-only bias, 8 groups of which the best 4 kept, gates normalised
and scaled by 2.5), YaRN RoPE (factor 40 over 4096 original positions,
beta 32 / 1, mscale 1) and eps 1e-6; the MTP module is not served.
"""
import dataclasses

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

PUBLISHED = dataclasses.replace(
    CONFIG,
    norm_eps=1e-6,
    scoring_func="sigmoid",
    n_group=8,
    topk_group=4,
    routed_scaling_factor=2.5,
    norm_topk_prob=True,
    n_routed_experts=256,
    yarn_factor=40.0,
    yarn_original_len=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=1.0,
    yarn_mscale_all_dim=1.0,
    mtp_depth=0,
)
