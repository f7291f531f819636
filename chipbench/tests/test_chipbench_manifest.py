"""BENCHMARK.json as the harness reads it: every name it gives has its
file, every cell's metrics have readers, and the entries keep the shapes
and sizes the manifest's format allows."""
import json
import re

import pytest

from chipbench import spec

MANIFEST = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_and_run_length_budget():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["chipbench"]
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of rs + 60 s, 2 x 90 s a
    # cell to compile, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_every_name_has_its_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert NAME.match(c["name"]) and (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("chipbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg.get("reduced", {}))
    seen = set()
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.HERE / "cells" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        mix = cell.traffic
        assert mix["prompt"]["max"] + mix["new_tokens"]["max"] <= mix["max_len"]
        assert mix["new_tokens"]["min"] >= 3  # the driver's slot bookkeeping needs >= 3


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics_have_readers_and_legal_fields(group):
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"


CLOSED_LOOP = sorted(m["name"] for m in MANIFEST["per_layer"]
                     if m["name"].endswith(".closed_loop"))


@pytest.mark.parametrize("name", CLOSED_LOOP)
def test_closed_loop_entries_mirror_their_base(name):
    """A ``<base>.closed_loop`` entry is ``<base>`` in the cells that judge
    their token gaps and not their rate: the same unit, direction and
    source, cells disjoint from the base's, and it moves an end-to-end
    metric that each of its cells reports."""
    base_name = name[: -len(".closed_loop")]
    entries = {m["name"]: m for m in MANIFEST["per_layer"] + MANIFEST["end_to_end"]}
    m, base = entries[name], entries[base_name]
    assert (m["unit"], m["better"], m["source"]) == (base["unit"], base["better"], base["source"])
    if "layer" in base:
        assert m["layer"] == base["layer"]
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert not set(m["workloads"]) & set(base.get("workloads", cells))
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in spec.load_cell(cell).end_to_end}
