"""A run with the timed path broken underneath comes out not correct; a
sound run and its fp8 control at the same small size come out apart.

Each test skips the look for a card and drives the rest of a run
(``runner.run_cell``) on the CPU at a small size, with the cell's own
limits.  The faults a serving cell can have: a step that leaves its state
unchanged (the prompt's cache never inserted), a token altered where it is
produced (the decode's logits shifted by one id), and for an MoE model the
routing altered where it is produced (each token sent to its least likely
experts).  The other faults of the list (half a batch left out, the
exchange between chips left out) belong to training and to several chips.
"""
import time

import pytest
import torch

from chipbench import check, runner
from chipbench.tests.support import CELLS, tiny

SEED = 2 ** 31 + 99


def _run(name, **kw):
    return runner.run_cell(tiny(name, **kw), SEED, 2.0, False, "cpu", time.perf_counter())


#: the cells, and the dense cell with an image on every request (the
#: harness's path for a multimodal mix, which no cell runs yet)
RUNS = [(name, {}) for name in CELLS] + [("pixtral-12b.code", {"images": True})]


@pytest.mark.parametrize("name,mix", RUNS)
def test_a_sound_run_is_correct(name, mix):
    res = _run(name, **mix)
    assert res["correct"], res["checks"]
    assert res["checks"]["missing"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name,mix", RUNS)
def test_state_left_unchanged_is_caught(name, mix, monkeypatch):
    from repro_torch.serving import engine

    monkeypatch.setattr(engine, "insert_prefix", lambda cache, prefix, slot, length: cache)
    res = _run(name, **mix)
    assert not res["correct"]
    assert res["checks"]["gap"]["value"] > res["checks"]["gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_token_altered_where_produced_is_caught(name, monkeypatch):
    from repro_torch.models import layers

    real = layers.lm_logits

    def shifted(w, x, tied):
        out = real(w, x, tied)
        return out.roll(1, dims=-1) if x.shape[1] == 1 else out  # decode steps only

    monkeypatch.setattr(layers, "lm_logits", shifted)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["gap"]["value"] > res["checks"]["gap"]["limit"]


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("mixtral")])
def test_routing_altered_where_produced_is_caught(name, monkeypatch):
    from repro_torch.models import moe

    def worst(p, xt, cfg):
        probs = torch.softmax(xt.float() @ p["router"], dim=-1)
        gates, eidx = torch.topk(-probs, cfg.experts_per_token, dim=-1)
        gates = -gates
        return gates / gates.sum(-1, keepdim=True), eidx, torch.zeros(())

    monkeypatch.setattr(moe, "_route", worst)
    # the router's logits spread as at full width (0.02 x sqrt(d_model)) only
    # at a wide d_model; at 64 the worst experts lie close to the best
    res = _run(name, d_model=1024)
    assert not res["correct"]
    assert res["checks"]["route_gap"]["value"] > res["checks"]["route_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_reads_far_above_the_program(name):
    """The control at a small size: the reference in fp8 in the program's
    place, read at the positions the program served.  The program here is
    float32 and reads 0; the control reads more on every seed."""
    cell = tiny(name, check_requests=8, new_tokens={"dist": "uniform", "min": 8, "max": 24})
    for seed in (1, 2, 3):
        d = runner.drive(cell, seed, 2.0, False, "cpu", time.perf_counter())
        rids = check.sample(d.record, seed, cell.traffic["check_requests"])
        v = check.readings(d.record, cell.config, d.params, d.images, d.stream, rids,
                           control=True)
        assert v["gap"] < 1e-3
        assert v["control_gap"] > 10 * max(v["gap"], 1e-3), v
