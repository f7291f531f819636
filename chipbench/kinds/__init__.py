"""Model kinds: what the benchmark knows of one family of architectures.

A configuration file names its kind (``"kind"``; ``"gqa"`` where it names
none), and ``kinds/<kind>.py`` holds everything of that family the
harness needs: the seeded weights' leaves, the plain reference and its
fp8 control, how many routing calls a forward makes and which routed
selections an expert takes, and the useful FLOPs.  The harness loads the
file by its path, so a new kind is a new file:

* ``leaves(config)``: ``(path, shape, kind, scale, f32)`` for every
  parameter, in draw order (``weights.Leaf``); paths under ``"groups"``
  address the program's layer groups as ``"0"``, ``"1"``, ...;
* ``Reference(config, params, precision)``, ``precision`` "f32" or "fp8",
  with ``.logits(tokens, out_positions, image, routes)`` -> (logits at
  ``out_positions``, route gap) and ``.router_logits`` (per MoE layer);
* ``moe_layers(config)``: the routing calls of one forward;
* ``keep(sel, config)``: which (token, choice) pairs of one routing call
  an expert takes;
* ``route_gaps(judge, chooser, config)``: the widest gap by which an
  expert ``chooser``'s router logits select lies below ``judge``'s k-th best;
* ``token_flops_but_attention``, ``attention_flops``, ``prefill_flops``,
  ``decode_flops``: the useful FLOPs (see ``gqa.py``).

The key ``"kind"`` is the benchmark's: no field of the program's
``ArchConfig`` has that name, so ``spec.arch_config`` leaves it out.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

#: where the kinds' files are
DIR = Path(__file__).resolve().parent

def load(kind: str) -> ModuleType:
    """``DIR/<kind>.py``, loaded by its path once and kept as
    ``chipbench.kinds.<kind>``, so an import of that name finds the same
    module."""
    path = DIR / f"{kind}.py"
    name = f"{__name__}.{kind}"
    mod = sys.modules.get(name)
    if mod is not None and Path(mod.__file__).resolve() == path.resolve():
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"no model kind {kind!r}: {path} is missing")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    try:
        mod_spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return mod


def of(config: Dict[str, Any]) -> ModuleType:
    """The kind a configuration names, ``gqa`` where it names none."""
    return load(config.get("kind", "gqa"))
