"""Small copies of the benchmark's cells for the CPU tests: every width
cut, float32, a few slots and short prompts; the mixes and limits as the
cells have them otherwise."""
from __future__ import annotations

import dataclasses

from chipbench import spec

CELLS = ("pixtral-12b.code", "mixtral-8x7b-l16.conversation")


def tiny(name: str, d_model: int = 64, **mix) -> spec.Cell:
    cell = spec.load_cell(name)
    c = dict(cell.config)
    c.update(n_layers=2, d_model=d_model, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, dtype="float32")
    if c.get("frontend"):
        c.update(frontend_dim=32, frontend_len=8)
    if c.get("sliding_window"):
        c.update(sliding_window=256)
    m = dict(cell.traffic)
    m.update(slots=4, max_len=256, prompt={"dist": "loguniform", "min": 16, "max": 120},
             new_tokens={"dist": "uniform", "min": 3, "max": 12}, preroll_s=0.2,
             check_requests=3)
    if m["loop"] == "open":
        m["rate_per_s"] = 40.0
    else:
        m["clients"] = 4
    m.update(mix)
    return dataclasses.replace(cell, config=c, traffic=m)
