"""Seeded weights and images, made by the benchmark on the device.

The benchmark makes the inputs that both the program and the reference
read: the parameter tree in the program's layout (stacked layers first,
weights ``(d_in, d_out)``), its leaves listed by the configuration's kind
(``kinds/<kind>.py``) and drawn leaf by leaf on the card from one
``torch.Generator`` in the dtype they are served in, and the image patch
embeddings.  ``check_layout`` holds the tree against the program's own
``param_shapes`` so a changed layout fails at set-up, not as wrong numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import kinds

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: (path, shape, kind, scale, f32): kind "normal" draws N(0, scale^2),
#: "norm" draws a norm scale N(1, 0.1^2) (not all ones, so a scale the
#: program dropped or doubled shows in the output); f32 draws in float32
#: whatever the served dtype.  A path ``("groups", "<i>", ...)`` is a leaf
#: of the program's i-th layer group.
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float, bool]


def served_dtype(config: Dict[str, Any]) -> torch.dtype:
    return _DTYPES[config.get("dtype", "bfloat16")]


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make(config: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The parameter tree from ``seed``: one draw per leaf of the
    configuration's kind (``kinds/<kind>.py``), in its order, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    dtype = served_dtype(config)
    tree: Dict[str, Any] = {}
    for path, shape, kind, scale, f32 in kinds.of(config).leaves(config):
        dt = torch.float32 if f32 else dtype
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        if kind == "norm":
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(scale)
        _put(tree, path, w)
    groups = tree["groups"]
    tree["groups"] = [groups[str(i)] for i in range(len(groups))]
    return tree


def images(config: Dict[str, Any], seed: int, n: int, device) -> torch.Tensor:
    """``n`` seeded images as patch embeddings (n, frontend_len,
    frontend_dim) in the served dtype, drawn apart from the weights."""
    gen = torch.Generator(device=device).manual_seed((seed + 0x1A6E) % (1 << 63))
    shape = (n, config["frontend_len"], config["frontend_dim"])
    return torch.randn(shape, generator=gen, device=device, dtype=served_dtype(config))


def check_layout(params: Dict[str, Any], expected: Dict[str, Any]) -> None:
    """Raise unless ``params`` has the tree, shapes and dtypes of
    ``expected`` (the program's ``param_shapes()``)."""
    def walk(a, b, where):
        if isinstance(b, dict):
            if not isinstance(a, dict) or set(a) != set(b):
                raise ValueError(f"parameter layout differs at {where}: "
                                 f"{sorted(a) if isinstance(a, dict) else type(a)} vs {sorted(b)}")
            for k in b:
                walk(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, list):
            if not isinstance(a, list) or len(a) != len(b):
                raise ValueError(f"parameter layout differs at {where}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}/{i}")
        elif tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(f"parameter {where}: {tuple(a.shape)} {a.dtype} "
                             f"vs the program's {tuple(b.shape)} {b.dtype}")

    walk(params, expected, "")
