"""The traffic generator: seeded, deterministic, the same work under every
seed; and the open and closed loops as the driver runs them."""
import time
from collections import Counter

import numpy as np
import pytest
import torch

from chipbench import harness, spec
from chipbench.tests.support import CELLS, tiny
from chipbench.traffic import Traffic


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_stream_every_seed_same_work(name):
    cell = spec.load_cell(name)
    mix, vocab = cell.traffic, cell.config["vocab_size"]
    big = 2 ** 31 + 12345
    a, b, c = Traffic(mix, big, vocab), Traffic(mix, big, vocab), Traffic(mix, 7, vocab)
    pool = mix["pool"]
    sa = [a.spec(k) for k in range(2 * pool)]
    assert sa == [b.spec(k) for k in range(2 * pool)]
    assert a.prompt(5) == b.prompt(5) and a.prompt(5) != c.prompt(5)
    assert [c.spec(k) for k in range(2 * pool)] == sa  # the same work at the same times
    first = Counter((s.prompt_len, s.new_tokens, s.gap_s) for s in sa[:pool])
    second = Counter((s.prompt_len, s.new_tokens, s.gap_s) for s in sa[pool:])
    assert first == second  # every block the same multiset
    assert [s.prompt_len for s in sa[:pool]] != [s.prompt_len for s in sa[pool:]]  # reordered
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= s.prompt_len <= hi for s in sa)
    assert all(mix["new_tokens"]["min"] <= s.new_tokens <= mix["new_tokens"]["max"] for s in sa)
    assert all(s.prompt_len + s.new_tokens <= mix["max_len"] for s in sa)
    assert all(1 <= t < vocab for t in a.prompt(3))


def test_open_loop_rate_and_due_times():
    cell = spec.load_cell("pixtral-12b.code")
    mix = cell.traffic
    t = Traffic(mix, 3, cell.config["vocab_size"])
    due = t.due_offsets(mix["pool"] * 4)
    assert np.all(np.diff(due) > 0)
    rate = len(due) / due[-1]
    assert rate == pytest.approx(mix["rate_per_s"], rel=0.05)


def _drive(name, seconds, **mix):
    cell = tiny(name, **mix)
    torch.manual_seed(0)
    arch = spec.arch_config(cell.config)
    params, images, engine, _ = harness.setup(cell.config, arch, cell.traffic, 1, "cpu", False)
    stream = Traffic(cell.traffic, 1, cell.config["vocab_size"])
    d = harness.Driver(engine, cell.config, cell.traffic, stream, images)
    t0 = time.perf_counter()
    d.start(t0)
    d.run_until(t0 + seconds)
    return cell, d, t0


def test_closed_loop_keeps_every_client_busy():
    cell, d, t0 = _drive("mixtral-8x7b-l16.conversation", 0.5)
    clients = cell.traffic["clients"]
    outstanding = [q for q in d.requests.values() if q.tokens is None]
    assert len(outstanding) == clients
    done = sorted((q for q in d.requests.values() if q.tokens is not None), key=lambda q: q.done)
    assert done, "no request finished"
    sends = sorted(q.sent for q in d.requests.values() if q.sent > t0)
    assert sends and set(sends) <= {q.done for q in done}  # a send only at a completion
    for s in d.steps:  # every decode step ran every client's slot
        assert len(s.decode_slots) == clients


def test_open_loop_sends_on_schedule_whatever_the_engine_does():
    cell, d, t0 = _drive("pixtral-12b.code", 0.5)
    due = t0 + d.stream.due_offsets(len(d.requests))
    assert [q.sent for q in sorted(d.requests.values(), key=lambda q: q.rid)] == list(due)
    for q in d.requests.values():
        if q.admitted is not None:
            assert q.admitted >= q.sent - 0.05  # released when due, admitted after


def test_requests_recorded_as_served():
    cell, d, _ = _drive("mixtral-8x7b-l16.conversation", 0.5)
    for q in d.requests.values():
        if q.tokens is not None:
            assert len(q.tokens) == q.new_tokens == len(q.times)
            assert q.times == sorted(q.times)
            assert len(q.decodes) == q.new_tokens - 1


def test_routing_recorded_through_the_window_and_the_router_restored():
    """An MoE run records the expert selection of every prefill and decode
    step of the pre-roll and the window, and leaves the program's router as
    it found it."""
    from repro_torch.models import moe

    from chipbench import runner

    real = moe._route
    cell = tiny("mixtral-8x7b-l16.conversation")
    d = runner.drive(cell, 2 ** 31 + 3, 0.5, False, "cpu", time.perf_counter())
    assert moe._route is real
    rec = d.record
    served = [q for q in rec.requests.values() if q.tokens is not None]
    assert served
    for q in served:
        assert len(rec.prefill_routes[q.rid]) == cell.config["n_layers"]
        assert all(step in rec.decode_routes for step, _ in q.decodes)
