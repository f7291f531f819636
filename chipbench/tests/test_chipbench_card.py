"""On the card, at a cell's own size: the program's readings under the
cell's limits and the fp8 control's above them.  Marked ``gpu``; skips
without a CUDA device.  Run it on the card with

    python3 -m pytest -q -m gpu chipbench/tests/test_chipbench_card.py
"""
import time

import pytest

from chipbench import check, runner, spec
from chipbench.tests.support import CELLS


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their published widths")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_within_and_control_beyond_the_limits(card, name):
    cell = spec.load_cell(name)
    d = runner.drive(cell, 2 ** 31 + 77, 10.0, False, card, time.perf_counter())
    want = int(cell.traffic["check_requests"])
    rids = check.sample(d.record, 2 ** 31 + 77, want)
    assert len(rids) == want
    v = check.readings(d.record, cell.config, d.params, d.images, d.stream, rids, control=True)
    lim = cell.limits
    assert v["gap"] <= lim["gap"] < v["control_gap"], v
    if "route_gap" in v:
        assert v["route_gap"] <= lim["route_gap"], v
    assert v["short"] == 0
