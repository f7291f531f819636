"""The manifest and the data files a cell names: its configuration, its
traffic mix and its output limits, each found by name."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]   # the configuration file, as written
    traffic: Dict[str, Any]  # the traffic file, as written
    limits: Dict[str, float]  # cells/<name>.json: each compared number's limit
    end_to_end: tuple        # the manifest's end-to-end metric entries of this cell
    per_layer: tuple         # the manifest's per-layer metric entries of this cell


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the manifest, with the files it names."""
    manifest = _read(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path.name}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read(ROOT / cfg_entry["file"]),
        traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_read(HERE / "cells" / f"{name}.json")["limits"],
        end_to_end=tuple(m for m in manifest["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in manifest["per_layer"] if _applies(m, name)),
    )


def arch_config(config: Dict[str, Any]):
    """The program's ``ArchConfig`` from a configuration file: every key
    that names one of its fields, the rest (source, assumptions) left out."""
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return ArchConfig(**kw)
