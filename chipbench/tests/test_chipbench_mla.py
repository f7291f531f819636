"""The ``mla`` kind (``chipbench/kinds/mla.py``) and its cell: the leaves
against the program's layout at full size, the useful FLOPs, the route
gaps of the grouped router, the three readers the cell adds, the cell run
to ``correct`` at a tiny size on the CPU, and (marked ``gpu``) at its own
size on the card with the fp8 control beyond the limits."""
import dataclasses
import time

import pytest
import torch

from chipbench import check, cost, harness, kinds, runner, spec, weights
from chipbench.harness import DECODE, PREFILL

CELL = "deepseek-v3-ep32-l30.longctx"
mla = kinds.load("mla")


def _config():
    return spec.load_cell(CELL).config


def test_the_cell_names_the_kind():
    c = _config()
    assert kinds.of(c) is mla and mla.moe_layers(c) == 27
    assert (c["n_experts"], c["n_routed_experts"], c["experts_per_token"]) == (8, 256, 8)


def test_leaves_are_the_programs_layout_at_full_size():
    from repro_torch.models import bundle

    c = _config()
    tree = {}
    for path, shape, _, _, f32 in mla.leaves(c):
        dt = torch.float32 if f32 else weights.served_dtype(c)
        weights._put(tree, path, torch.empty(shape, dtype=dt, device="meta"))
    tree["groups"] = [tree["groups"][str(i)] for i in range(len(tree["groups"]))]
    weights.check_layout(tree, bundle(spec.arch_config(c)).param_shapes())
    n = sum(torch.Size(leaf[1]).numel() for leaf in mla.leaves(c))
    assert 19.3e9 < n < 19.5e9  # 30 layers of 8 held experts, the whole vocabulary


def test_flops_count_the_head_once_a_prefill():
    c = _config()
    d, v = c["d_model"], c["vocab_size"]
    head = 2 * d * v
    per = mla.token_flops_but_attention(c)
    n = 5000
    att = sum(mla.attention_flops(c, p) for p in range(n))
    assert mla.prefill_flops(c, n) == n * (per - head) + head + att
    assert mla.decode_flops(c, [10, 20]) == 2 * per + mla.attention_flops(
        c, 10) + mla.attention_flops(c, 20)
    # attention: 30 layers x 2 x 128 heads x keys x (192 + 128)
    assert mla.attention_flops(c, 99) == 30 * 2 * 128 * 100 * 320
    # the layers' multiply-adds from the parameter counts: MLA's five
    # projections every layer, SwiGLU 18432 in 3, and in 27 the router, the
    # shared expert and 8 x 8/256 of a routed one
    mla_params = 7168 * 1536 + 1536 * 128 * 192 + 7168 * 576 + 512 * 128 * 256 + 128 * 128 * 7168
    expert = 3 * 7168 * 2048
    want = 2 * (30 * mla_params + 3 * 3 * 7168 * 18432
                + 27 * (7168 * 256 + expert + 0.25 * expert)) + head
    assert per == int(want)


def test_route_gaps_of_a_grouped_router_on_a_tie():
    """16 experts in 4 groups, 2 kept, top 4.  Groups 1 and 2 tie for the
    second place: a chooser that keeps group 2 where the judge keeps group 1
    is 0 away; one whose expert lies 0.1 below the judge's 4th best is 0.1
    away; one that keeps a group 0.3 behind the kept ones is 0.3 away."""
    c = {"n_group": 4, "topk_group": 2, "experts_per_token": 4}
    s = torch.zeros(1, 16)
    s[0, 0:2] = torch.tensor([1.0, 0.9])  # group 0: 1.9
    s[0, 4:7] = torch.tensor([0.6, 0.5, 0.4])  # group 1: 1.1
    s[0, 8:10] = torch.tensor([0.55, 0.55])  # group 2: 1.1, a tie
    s[0, 12:14] = torch.tensor([0.4, 0.4])  # group 3: 0.8
    assert sorted(mla.select(s, c)[0].tolist()) == [0, 1, 4, 5]
    assert mla.selection_gap(s, mla.select(s, c), c) == 0.0
    assert mla.selection_gap(s, torch.tensor([[0, 1, 8, 9]]), c) == pytest.approx(0.0, abs=1e-6)
    assert mla.selection_gap(s, torch.tensor([[0, 1, 4, 6]]), c) == pytest.approx(0.1, abs=1e-6)
    assert mla.selection_gap(s, torch.tensor([[0, 1, 12, 13]]), c) == pytest.approx(0.3, abs=1e-6)
    # route_gaps reads the chooser's own selection off its scores
    t = s.clone()
    t[0, 8] += 0.2  # the chooser prefers group 2: experts 0, 1, 8, 9
    assert mla.route_gaps([s], [t], c) == pytest.approx(0.0, abs=1e-6)
    t[0, 12:14] += 1.0  # the chooser keeps group 3: experts 12, 13, 0, 1
    assert mla.route_gaps([s], [t], c) == pytest.approx(0.3, abs=1e-6)
    assert bool(mla.keep(torch.zeros(3, 2, dtype=torch.long), c).all())


# -- the readers -----------------------------------------------------------------
GEMM = "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel" \
       "13GemmUniversalINS5_17GroupProblemShapeIN4cute5tupleIJiiiEEEEE"


def _ctx(trace=None, program=None, steps=(), prefill_routes=None, decode_routes=None):
    c = _config()
    rec = harness.Record(c, {}, 16, 16512, 10.0, 20.0, {}, list(steps), prefill_routes or {},
                         decode_routes or {}, trace=trace, trace_bounds=(14.0, 15.0),
                         program=program)
    return runner.Context(c, rec, trace, 5.0,
                          peaks={"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12})


def test_mla_flash_roofline_prices_the_model_head_size():
    steps = [harness.Step(14.1, 14.6, [7], {}, None, spans=[(PREFILL, 14.1, 14.5, 0, 4096)])]
    trace = {"ranges": {(PREFILL, 0): (100.0, 900.0)},
             "device": [("fa_tc_kernel<256>", 200.0 + 20 * i, 210.0 + 20 * i) for i in range(30)]
             + [("nvjet_gemm", 150.0, 190.0)]}
    ctx = _ctx(trace, steps=steps)
    q = torch.empty((1, 4096, 128, 192), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1, 4096, 128, 128), dtype=torch.bfloat16, device="meta")
    w = cost.flash_attention(q, q, v, True, None)
    bound = 30 * max(w.flops / 989e12, w.bytes / 3.35e12)
    assert runner.read_metric("mla.flash_roofline", ctx) == pytest.approx(
        100 * bound / (30 * 10e-6))
    assert runner.read_metric("mla.flash_roofline", _ctx(None, steps=steps)) is None


def _program(spans, dropped=0):
    return harness.Program([harness.ProgramSpan(*s) for s in spans], [], {}, dropped)


def test_moe_decode_host_ms_sums_the_moe_spans_of_each_decode_forward():
    dec = {"mode": "decode"}
    spans = [
        ("model.forward", 11.0, 11.2, dec), ("moe.route", 11.01, 11.02, {}),
        ("moe.experts", 11.02, 11.05, {}), ("moe.route", 11.1, 11.11, {}),
        ("model.forward", 12.0, 12.1, dec), ("moe.route", 12.0, 12.001, {}),
        ("model.forward", 13.0, 13.3, {"mode": "prefill"}), ("moe.route", 13.0, 13.2, {}),
        ("model.forward", 14.2, 14.4, dec), ("moe.route", 14.2, 14.3, {}),  # in the slice
        ("model.forward", 16.0, 16.1, dec), ("moe.experts", 16.0, 16.004, {}),
    ]
    ctx = _ctx(program=_program(spans))
    # three decode forwards outside the slice: 50, 1 and 4 ms
    assert runner.read_metric("moe.decode_host_ms", ctx) == pytest.approx(4.0)
    assert runner.read_metric("moe.decode_host_ms", _ctx(program=_program(spans, 3))) is None
    assert runner.read_metric("moe.decode_host_ms", _ctx()) is None
    no_moe = [s for s in spans if not s[0].startswith("moe.")]
    assert runner.read_metric("moe.decode_host_ms", _ctx(program=_program(no_moe))) is None


def test_moe_expert_roofline_prices_the_rows_routed_to_the_held_experts():
    d, f = 7168, 2048
    sel_pre = torch.tensor([[0, 9, 10, 11, 12, 13, 14, 15]] * 4 + [[1, 2, 9, 10, 11, 12, 13, 14]]
                           * 2)  # 4 rows to expert 0, 2 each to 1 and 2
    sel_dec = torch.tensor([[3, 9, 10, 11, 12, 13, 14, 15]] + [[20 + i for i in range(8)]])
    steps = [harness.Step(14.1, 14.6, [5], {0: 5}, [100], spans=[
        (PREFILL, 14.1, 14.3, 0, 6), (DECODE, 14.3, 14.5, 1, 2)])]
    launches = [(GEMM, 200.0 + 10 * i, 205.0 + 10 * i) for i in range(3 * 27)]
    trace = {"ranges": {(PREFILL, 0): (100.0, 1100.0), (DECODE, 1): (1200.0, 2200.0)},
             "device": launches + [(n, s + 1100.0, e + 1100.0) for n, s, e in launches]}
    ctx = _ctx(trace, steps=steps, prefill_routes={5: [sel_pre] * 27},
               decode_routes={0: [sel_dec] * 27})

    def bound(rows, touched):
        return max(3 * 2 * rows * d * f / 989e12,
                   2 * (touched * 3 * d * f + 2 * rows * d) / 3.35e12)

    want = 27 * (bound(8, 3) + bound(1, 1)) / (2 * 81 * 5e-6)
    assert runner.read_metric("moe.expert_roofline", ctx) == pytest.approx(100 * want)
    # a forward whose trace lost a launch is left out
    trace["device"] = launches[1:] + trace["device"][81:]
    want = 27 * bound(1, 1) / (81 * 5e-6)
    assert runner.read_metric("moe.expert_roofline", ctx) == pytest.approx(100 * want)
    assert runner.read_metric("moe.expert_roofline", _ctx(None, steps=steps)) is None


# -- the cell ------------------------------------------------------------------------
def tiny_mla(**mix):
    """The cell at a tiny size: every mechanism kept (3 layers, the first
    dense; 16 routed experts in 4 groups, 2 kept, top 4, 4 held from
    expert 4; YaRN over 32 original positions), f32."""
    cell = spec.load_cell(CELL)
    c = dict(cell.config)
    c.update(n_layers=3, n_dense_layers=1, d_model=64, n_heads=4, n_kv_heads=4, q_lora_rank=32,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, d_ff=128,
             moe_d_ff=32, n_experts=4, n_routed_experts=16, experts_per_token=4, n_group=4,
             topk_group=2, expert_offset=4, vocab_size=256, dtype="float32", yarn_original_len=32)
    m = dict(cell.traffic)
    m.update(slots=4, max_len=256, prompt={"dist": "loguniform", "min": 40, "max": 120},
             new_tokens={"dist": "uniform", "min": 3, "max": 12}, preroll_s=0.3,
             check_requests=3, rate_per_s=40.0)
    m.update(mix)
    return dataclasses.replace(cell, config=c, traffic=m)


def test_the_cell_runs_to_correct_at_a_tiny_size():
    cell = tiny_mla()
    res = runner.run_cell(cell, 2 ** 31 + 31, 2.0, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["gap"]["value"] < 1e-3
    assert res["checks"]["route_gap"]["value"] < 1e-4
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"prefill_mfu", "decode_mfu", "moe.decode_host_ms"} <= set(res["metrics"])


def test_the_program_records_its_mla_and_moe_spans():
    from repro_torch import obs

    cell = tiny_mla()
    d = runner.drive(cell, 2 ** 31 + 41, 1.0, True, "cpu", time.perf_counter())
    prog = d.record.program
    names = {s.name for s in prog.spans}
    assert {"mla.attention", "moe.route", "moe.experts"} <= names
    modes = {s.attrs["mode"] for s in prog.spans if s.name == "mla.attention"}
    assert modes == {"absorbed", "decompressed"}
    dec = [s for s in prog.spans if s.name == "mla.attention" and s.attrs["mode"] == "absorbed"]
    assert all(s.attrs["rows"] == 4 * 256 for s in dec)  # every slot's whole cache
    rows = sum(s.attrs["rows"] for s in prog.spans if s.name == "mla.attention")
    assert prog.counters["mla_latent_rows_total"] == rows
    ex = [s for s in prog.spans if s.name == "moe.experts"]
    assert {(s.attrs["held"], s.attrs["routed_over"]) for s in ex} == {(4, 16)}
    assert {s.attrs["scoring"] for s in prog.spans if s.name == "moe.route"} == {"sigmoid"}
    assert obs.get_telemetry().enabled is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its published widths")
    return "cuda"


@pytest.mark.gpu
def test_program_within_and_control_beyond_the_limits_on_the_card(card):
    cell = spec.load_cell(CELL)
    seed = 2 ** 31 + 77
    # 30 s: a request lives ~40 s here, so a 10 s window finishes too few to judge
    d = runner.drive(cell, seed, 30.0, False, card, time.perf_counter())
    want = int(cell.traffic["check_requests"])
    rids = check.sample(d.record, seed, want)
    assert len(rids) == want
    v = check.readings(d.record, cell.config, d.params, d.images, d.stream, rids, control=True)
    lim = cell.limits
    assert v["gap"] <= lim["gap"] < v["control_gap"], v
    assert v["route_gap"] <= lim["route_gap"], v
    assert v["short"] == 0
