"""The metric arithmetic: percentiles over every sample, TTFT censored at
the close, token gaps, the window's throughput, the per-step counts."""
import numpy as np
import pytest

from chipbench import check, cost, flops, harness, runner, stats, trace


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = rng.exponential(size=n).tolist()
        for q in (0, 50, 90, 95, 100):
            assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert np.isnan(stats.percentile([], 90))


def _record():
    """Window [10, 20]: request 0 sent in the pre-roll, 1 served in the
    window, 2 sent in the window and not served by its close, 3 sent after
    the close."""
    R = harness.Req
    reqs = {
        0: R(0, 9.0, 100, 4, admitted=9.0, times=[9.5, 9.5, 10.5, 11.0], tokens=[1] * 4, done=11.0),
        1: R(1, 12.0, 100, 3, admitted=12.5, times=[13.0, 13.0, 14.0], tokens=[1] * 3, done=14.0),
        2: R(2, 19.0, 100, 3, admitted=None, times=[]),
        3: R(3, 21.0, 100, 3),
    }
    steps = [harness.Step(10.0, 10.5, [], {0: 0}, [103, 1], spans=[]),
             harness.Step(12.5, 13.0, [1], {0: 0, 1: 1}, [104, 101], spans=[]),
             harness.Step(13.0, 14.0, [], {1: 1}, [105, 102], spans=[])]
    return harness.Record({"n_layers": 1}, {}, 2, 256, 10.0, 20.0, reqs, steps, {}, {})


def _ctx(rec):
    return runner.Context(rec.config, rec, None, 5.0, peaks={})


def test_ttft_counts_the_wait_of_an_unserved_request():
    ctx = _ctx(_record())
    # requests 1 (1.0 s) and 2 (censored: 20 - 19 = 1.0 s); 0 was sent before the window
    assert runner.read_metric("ttft_p90_ms", ctx) == pytest.approx(1000.0)
    ctx.record.requests[2].sent = 17.0
    assert runner.read_metric("ttft_p90_ms", ctx) == pytest.approx(
        stats.percentile([1000.0, 3000.0], 90))


def test_queue_wait_to_admission_censored():
    ctx = _ctx(_record())
    assert runner.read_metric("engine.queue_wait_p90_ms", ctx) == pytest.approx(
        stats.percentile([500.0, 1000.0], 90))


def test_itl_gaps_ending_in_the_window_and_throughput():
    ctx = _ctx(_record())
    gaps = [1.0, 0.5, 0.0, 1.0]  # 9.5->10.5, 10.5->11, 13->13, 13->14
    assert runner.read_metric("itl_p95_ms", ctx) == pytest.approx(
        stats.percentile(gaps, 95) * 1e3)
    assert runner.read_metric("itl_p95_ms.overload", ctx) == runner.read_metric("itl_p95_ms", ctx)
    assert runner.read_metric("ttft_p90_ms.overload", ctx) == runner.read_metric("ttft_p90_ms", ctx)
    assert runner.read_metric("output_tok_s", ctx) == pytest.approx(5 / 10.0)
    assert runner.read_metric("setup_s", ctx) == 5.0


def test_occupancy_and_live_share():
    ctx = _ctx(_record())
    assert runner.read_metric("engine.occupancy", ctx) == pytest.approx((0.5 + 1.0 + 0.5) / 3)
    live = [103 / 512, (104 + 101) / 512, 102 / 512]
    assert runner.read_metric("kvcache.live_share", ctx) == pytest.approx(sum(live) / 3)


CLOSED_LOOP = sorted(p.name[: -len(".closed_loop.py")]
                     for p in (runner.spec.HERE / "metrics").glob("*.closed_loop.py"))


@pytest.mark.parametrize("base", CLOSED_LOOP)
def test_closed_loop_reader_is_its_base_reading(base, monkeypatch):
    asked = []
    monkeypatch.setattr(runner.Context, "read", lambda self, name: asked.append(name) or 42.5)
    assert runner.read_metric(f"{base}.closed_loop", _ctx(_record())) == 42.5
    assert asked == [base]


def test_untraced_run_leaves_trace_metrics_out():
    ctx = _ctx(_record())
    for name in ("dispatch.kernels_per_decode_step", "flash_roofline", "decode_roofline",
                 "device.idle_share", "prefill_mfu", "decode_mfu"):
        assert runner.read_metric(name, ctx) is None


class _Ev:
    def __init__(self, name, start, end, cuda):
        self.name = name
        self.device_type = "DeviceType.CUDA" if cuda else "DeviceType.CPU"
        self.is_user_annotation = False

        class _R:
            pass
        self.time_range = _R()
        self.time_range.start, self.time_range.end = start, end


def test_trace_reduction_and_kernel_metrics():
    ev = [_Ev("chipbench.prefill#0", 0, 1000, False), _Ev("chipbench.decode#1", 1100, 1500, False),
          _Ev("fa_tc_kernel<128>", 100, 300, True), _Ev("gemm", 300, 600, True),
          _Ev("decode_split_kernel", 1200, 1250, True),
          _Ev("decode_combine_kernel", 1250, 1260, True),
          _Ev("Memset (Device)", 1300, 1310, True), _Ev("ampere_gemm", 1400, 1450, True)]
    tr = trace.reduce(ev, 0.002)
    assert tr["busy_s"] == pytest.approx((500 + 60 + 10 + 50) * 1e-6)
    assert tr["device_ops"][0] == ("gemm", pytest.approx(300e-6))
    assert tr["idle_gaps"][0][1] == pytest.approx(600e-6)  # 600 -> 1200 spans both ranges' edge
    cfg = {"n_layers": 1, "n_heads": 32, "n_kv_heads": 8, "head_dim": 128, "d_model": 4096}
    steps = [harness.Step(0, 1, [], {}, None, spans=[(harness.PREFILL, 0, 1, 0, 1024)]),
             harness.Step(1, 2, [], {0: 0}, [900, 1], spans=[(harness.DECODE, 1, 2, 1, 2)])]
    rec = harness.Record(cfg, {}, 2, 4096, 0, 2, {}, steps, {}, {}, trace=tr)
    ctx = runner.Context(cfg, rec, tr, 1.0, peaks={"bf16_flops_per_s": 989e12,
                                                   "hbm_bytes_per_s": 3.35e12})
    assert runner.read_metric("dispatch.kernels_per_decode_step", ctx) == 3.0
    import torch
    q = torch.empty((1, 1024, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 1024, 8, 128), dtype=torch.bfloat16, device="meta")
    w = cost.flash_attention(q, k, k, True, None)
    want = 100 * max(w.flops / 989e12, w.bytes / 3.35e12) / 200e-6
    assert runner.read_metric("flash_roofline", ctx) == pytest.approx(want)
    # slot 0 alone is active: slot 1's rows are the kernel's waste, not its bound
    q = torch.empty((1, 1, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 4096, 8, 128), dtype=torch.bfloat16, device="meta")
    w = cost.decode_attention(q, k, k, [900])
    want = 100 * max(w.flops / 989e12, w.bytes / 3.35e12) / 60e-6
    assert runner.read_metric("decode_roofline", ctx) == pytest.approx(want)
    assert runner.read_metric("device.idle_share", ctx) == pytest.approx(1 - tr["busy_s"] / 0.002)


def test_mfu_over_spans_outside_the_profiled_slice():
    cfg = {"n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_model": 64,
           "d_ff": 128, "vocab_size": 256}
    R = harness.Req
    reqs = {0: R(0, 0.0, 50, 3), 1: R(1, 0.0, 70, 3)}
    steps = [harness.Step(1.0, 2.0, [0, 1], {0: 0, 1: 1}, [51, 71],
                          spans=[(harness.PREFILL, 1.0, 1.2, 0, 64),
                                 (harness.PREFILL, 1.2, 1.5, 1, 128),
                                 (harness.DECODE, 1.5, 1.6, 2, 2)]),
             harness.Step(2.0, 3.0, [], {0: 0, 1: 1}, [52, 72],
                          spans=[(harness.DECODE, 2.0, 2.5, 3, 2)])]
    rec = harness.Record(cfg, {}, 2, 256, 0.0, 10.0, reqs, steps, {}, {})
    rec.trace_bounds = (2.2, 2.4)  # overlaps the second decode: left out
    ctx = runner.Context(cfg, rec, None, 1.0, peaks={"bf16_flops_per_s": 1e9})
    pre = flops.prefill_flops(cfg, 50) + flops.prefill_flops(cfg, 70)
    assert runner.read_metric("prefill_mfu", ctx) == pytest.approx(100 * pre / (0.5 * 1e9))
    dec = flops.decode_flops(cfg, [50, 70])
    assert runner.read_metric("decode_mfu", ctx) == pytest.approx(100 * dec / (0.1 * 1e9))


def test_the_check_samples_requests_the_window_finished():
    """Only requests finished inside the window are judged, the longest among
    them always, the rest drawn from the seed."""
    R = harness.Req
    reqs = {i: R(i, 10.0 + i, 100 + 10 * i, 3, times=[0.0] * 3, tokens=[1] * 3,
                 done=10.5 + i) for i in range(8)}
    reqs[0].done = 9.0  # finished before the window opened
    reqs[7].done = 21.0  # after it closed
    rec = harness.Record({"n_layers": 1}, {}, 2, 256, 10.0, 20.0, reqs, [], {}, {})
    picked = check.sample(rec, 2 ** 31 + 5, 4)
    assert picked[0] == 6 and len(picked) == 4  # 6: the longest finished in the window
    assert set(picked) <= {1, 2, 3, 4, 5, 6}
    assert picked == check.sample(rec, 2 ** 31 + 5, 4)
    assert sorted(check.sample(rec, 1, 10)) == [1, 2, 3, 4, 5, 6]
