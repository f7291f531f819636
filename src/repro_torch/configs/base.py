"""Architecture configuration schema + the assigned input-shape registry.

A copy of the reference package's ``configs/base.py``: the port keeps its own
copy of these pure-data modules and never imports the reference package."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One model architecture, fully specifying the model to build."""

    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # --- attention ---------------------------------------------------------
    attention: str = "gqa"  # gqa | mla
    sliding_window: Optional[int] = None
    rope_mode: str = "full"  # full | half (chatglm 2d-RoPE style) | none
    rope_theta: float = 1e4

    # --- MLA (deepseek) ----------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP / MoE ---------------------------------------------------------
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0  # leading dense layers in an MoE stack (deepseek)
    moe_d_ff: int = 0  # expert hidden dim when != d_ff
    capacity_factor: float = 1.25

    # --- router (DeepSeek-V3's "noaux_tc"; the defaults are Mixtral's) -----
    scoring_func: str = "softmax"  # softmax | sigmoid (sigmoid adds a choice-only bias)
    n_group: int = 1  # expert groups; the topk_group best (sum of top 2) are kept
    topk_group: int = 1
    routed_scaling_factor: float = 1.0  # applied to the top-k gates
    norm_topk_prob: bool = True  # the top-k gates normalised to sum 1
    # the router's width; 0 means n_experts.  Set, the layer holds the
    # n_experts experts from global id expert_offset and drops no token
    n_routed_experts: int = 0
    expert_offset: int = 0

    # --- YaRN RoPE (MLA's rotary part; 0 factor = plain RoPE) --------------
    yarn_factor: float = 0.0
    yarn_original_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # --- structure ---------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)  # cycled over layers
    enc_dec: bool = False
    n_encoder_layers: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp_depth: int = 0  # deepseek multi-token-prediction extra blocks

    # --- SSM / xLSTM -------------------------------------------------------
    ssm_state: int = 0  # mamba2 N
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    shared_attn_every: int = 0  # zamba2: shared attn block period

    # --- modality frontend stubs -------------------------------------------
    frontend: Optional[str] = None  # vit | audio
    frontend_dim: int = 0  # raw patch/frame embedding dim
    frontend_len: int = 0  # patches/frames per sample

    # --- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"
    sublayer_sharding: bool = True  # sharding hints (unused by the port)

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def router_width(self) -> int:
        """Experts the router scores: every expert of the model, of which
        this layer holds ``n_experts``."""
        return self.n_routed_experts or self.n_experts

    @property
    def is_recurrent(self) -> bool:
        return any(b in ("mlstm", "slstm", "mamba2") for b in self.block_pattern)

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic long-context decode (bounded or O(1) state)."""
        return self.is_recurrent or self.sliding_window is not None

    def block_at(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_groups(self) -> Tuple[Tuple[str, int], ...]:
        """Contiguous (block type, count) runs — each run is one stacked layer group."""
        runs = []
        for i in range(self.n_layers):
            b = self.block_at(i)
            if i >= self.n_dense_layers and b == "attn" and self.n_experts:
                b = "moe"
            if runs and runs[-1][0] == b:
                runs[-1][1] += 1
            else:
                runs.append([b, 1])
        return tuple((b, n) for b, n in runs)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    microbatch: int = 0  # grad-accum microbatch (train); 0 = no accumulation


#: The assigned input-shape set (identical for all 10 LM-family archs).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", microbatch=16),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=min(cfg.n_layers, 2 * len(cfg.block_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_dense_layers=min(cfg.n_dense_layers, 1),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_chunk=32,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        shared_attn_every=min(cfg.shared_attn_every, 2) if cfg.shared_attn_every else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        mtp_depth=cfg.mtp_depth,
        dtype="float32",
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
