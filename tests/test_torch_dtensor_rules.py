"""Every op that the port's sharded cells dispatch on a DTensor has a
sharding rule in the torch of the card's host (2.11), on the CPU here.

``tests/data/dtensor_ops_torch-2.11.txt`` lists the ops that torch 2.11's
DTensor can shard; ``tools/dtensor_rules.py`` writes it on the card's host.
The test runs each of the ten archs' ``reduced()`` train, prefill and
decode cells on a fake (2, 2) process group as
``test_torch_dryrun.py::test_reduced_cells`` builds them (Mixtral in both
MoE modes), records every op that reaches a DTensor, and asserts that
each is in that list.  An op outside it runs at best through DTensor's
decomposition fallback, which shards ``index_add_`` in torch 2.13 and
not in 2.11, so the test holds the port to ops with a rule of their own:
a path that needs another fails on the CPU before it can fail on the
card's host.

What it cannot see: an op that has a rule in both versions whose rule
behaves differently.  torch 2.11's ``view`` rule refuses to flatten a
sharded dim that is not the first of the flattened group (an einsum over
sharded heads flattens such dims), where 2.13's accepts it; only a run on
the card's host shows those (README: the reduced cells through the chip
tool).

The last test holds xLSTM's sLSTM time loop to one region per rank: the
reduced cell dispatches as many DTensor ops at 2S tokens as at S.
"""
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution import sharding
from repro_torch.distribution.cost_analysis import CostCounter
from repro_torch.launch import dryrun

from test_torch_dryrun import CELL_SHAPES, MESHES, expected_calls

RULES = Path(__file__).parent / "data" / "dtensor_ops_torch-2.11.txt"


def card_host_rules() -> set:
    lines = RULES.read_text().splitlines()
    return {ln.strip() for ln in lines if ln.strip() and not ln.startswith("#")}


class _Recording(CostCounter):
    """The dry-run's counter, recording every op that has a DTensor argument
    (DTensor's own dispatch runs beneath it, so these are the ops DTensor is
    asked to shard)."""

    ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves

        if any(sharding.is_dtensor(a) for a in tree_leaves((args, kwargs or {}))):
            self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        return super().__torch_dispatch__(func, types, args, kwargs)


def dtensor_ops(monkeypatch, arch, shape, moe_impl="alltoall", cfg=None) -> dict:
    """{op: dispatches} of one reduced cell on the fake (2, 2) group."""
    cfg = cfg or reduced(get_config(arch))
    ops: dict = {}
    monkeypatch.setattr(_Recording, "ops", ops)
    monkeypatch.setattr(dryrun, "CostCounter", _Recording)
    cell = dryrun.run_cell(arch, shape.name, False, cfg=cfg, shape=shape, moe_impl=moe_impl,
                           mesh_shape=MESHES["2x2"], out_dir=None)
    assert cell["status"] == "ok", cell.get("traceback")
    kind = shape.kind
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == expected_calls(cfg, kind)
    return ops


def test_the_rules_file_is_the_card_hosts():
    head = RULES.read_text().splitlines()[0]
    assert head.startswith("# ops with a DTensor rule in torch 2.11"), head
    rules = card_host_rules()
    assert len(rules) > 500
    # ops that 2.11 lacks and the port routes around (each repair names its op)
    assert not rules & {"aten.index_add_.default", "aten.softplus_backward.default",
                        "aten.log_sigmoid_backward.default", "aten.roll.default",
                        "aten.index_copy_.default"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_dtensor_op_has_a_rule_on_the_card_host(arch, monkeypatch):
    rules = card_host_rules()
    cfg = reduced(get_config(arch))
    missing = {}
    # the dispatch MoE runs the same code in every MoE arch: Mixtral's cells
    # take it (DeepSeek-V3's twice as long)
    for mode in ("alltoall", "dispatch") if arch == "mixtral-8x7b" else ("alltoall",):
        for kind, shape in CELL_SHAPES.items():
            ops = dtensor_ops(monkeypatch, arch, shape, mode, cfg)
            assert ops, (kind, mode)
            for op in sorted(set(ops) - rules):
                missing.setdefault(op, []).append(f"{kind}/{mode}")
    assert not missing, missing


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_loop_dispatches_per_rank(kind, monkeypatch):
    """The reduced xLSTM cell at S and at 2S tokens makes the same DTensor
    dispatches, op by op: no step of the sLSTM's time loop reaches a
    DTensor."""
    base = CELL_SHAPES[kind]
    counts = []
    for s in (base.seq_len, 2 * base.seq_len):
        shape = ShapeConfig(base.name, s, base.global_batch, base.kind,
                            microbatch=base.microbatch)
        counts.append(dtensor_ops(monkeypatch, "xlstm-125m", shape))
    assert counts[0] == counts[1]
