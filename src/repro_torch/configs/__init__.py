"""Config registry: ``get_config(name)`` / ``ARCHS`` / shape registry."""
from __future__ import annotations

from typing import Dict

from .base import SHAPES, ArchConfig, ShapeConfig, reduced  # noqa: F401
from .chatglm3_6b import CONFIG as chatglm3_6b
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .pixtral_12b import CONFIG as pixtral_12b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .smollm_135m import CONFIG as smollm_135m
from .xlstm_125m import CONFIG as xlstm_125m
from .zamba2_1p2b import CONFIG as zamba2_1p2b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        mistral_large_123b,
        nemotron_4_340b,
        smollm_135m,
        chatglm3_6b,
        mixtral_8x7b,
        deepseek_v3_671b,
        pixtral_12b,
        seamless_m4t_large_v2,
        xlstm_125m,
        zamba2_1p2b,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(ARCHS)}")
    return ARCHS[name]
