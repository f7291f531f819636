"""The serving path's telemetry: the span tree of each ``Engine.step``, the
prefill padding counters, identical service with tracing on and off, and the
spans as ``torch.profiler`` ranges only while a session records."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.models import bundle
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.serving.engine import _next_pow2

PROMPTS = (5, 3, 9, 17)  # more requests than slots: admissions in later steps
SLOTS = 2

PREFILL_KIDS = ["engine.prefill.upload", "engine.prefill.forward",
                "engine.prefill.readback", "kvcache.insert"]
DECODE_KIDS = ["engine.decode.prepare", "engine.decode.index_readback",
               "engine.decode.upload", "engine.decode.forward",
               "engine.decode.readback", "engine.decode.retire"]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("smollm-135m", "zamba2-1.2b", "xlstm-125m"):
        mb = bundle(reduced(get_config(arch)))
        out[arch] = mb, mb.init(torch.Generator().manual_seed(0), device="cpu")
    return out


@pytest.fixture(autouse=True)
def _noop_handle():
    obs.disable()
    yield
    obs.disable()


def _engine(models, arch="smollm-135m", **cfg):
    mb, params = models[arch]
    return Engine(mb, params, EngineConfig(max_slots=SLOTS, max_len=64, **cfg))


def _submit_all(eng):
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPTS):
        eng.submit(Request(rid=f"r{i}", prompt=rng.integers(1, 255, size=n).tolist(),
                           max_new_tokens=3 + i))


def _served(eng):
    _submit_all(eng)
    done = eng.run()
    return {c.rid: (c.tokens, c.finish_reason) for c in done}, dict(eng.stats)


def _kids(tracer, span):
    return sorted(tracer.children_of(span), key=lambda s: s.t_start)


def _within(child, parent):
    return parent.t_start <= child.t_start <= child.t_end <= parent.t_end


def _check_forward(tracer, fwd, mode, rows, cfg, n_blocks):
    assert fwd.attrs == {"mode": mode, "rows": rows}
    kids = _kids(tracer, fwd)
    names = [k.name for k in kids]
    assert names == ["model.embed"] + ["model.block"] * n_blocks + ["model.head"]
    blocks = [k for k in kids if k.name == "model.block"]
    trunk = [b for b in blocks if b.attrs["kind"] != "shared_attn"]
    assert [b.attrs["layer"] for b in trunk] == list(range(cfg.n_layers))
    assert [b.attrs["kind"] for b in trunk] == [k for k, c in cfg.layer_groups()
                                               for _ in range(c)]
    assert all(_within(k, fwd) for k in kids)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_each_step_yields_the_span_tree(models, arch):
    eng = _engine(models, arch)
    cfg = eng.bundle.cfg
    mb = eng.model
    n_blocks = cfg.n_layers + mb.n_shared_apps
    with obs.enabled() as tel:
        _submit_all(eng)
        eng.run()
    tr = tel.tracer
    assert tr.n_dropped == 0 and not tr._stack
    steps = tr.find("engine.step")
    assert steps and all(s.parent_id is None for s in steps)
    assert sum(s.attrs["admitted"] for s in steps) == len(PROMPTS)
    by_rid = {}
    for st in steps:
        assert set(st.attrs) == {"admitted", "active"}
        kids = _kids(tr, st)
        want = ["engine.prefill"] * st.attrs["admitted"]
        want += ["engine.decode"] if st.attrs["active"] else []
        assert [k.name for k in kids] == want
        for k in kids:
            assert _within(k, st) and k.trace_id == st.span_id
            sub = _kids(tr, k)
            if k.name == "engine.prefill":
                assert [s.name for s in sub] == PREFILL_KIDS
                assert set(k.attrs) == {"rid", "prompt_len", "bucket", "pad_tokens"}
                plen = k.attrs["prompt_len"]
                assert k.attrs["bucket"] == (plen if cfg.is_recurrent else _next_pow2(plen))
                by_rid[k.attrs["rid"]] = k
                (fwd,) = tr.children_of(sub[1])
                _check_forward(tr, fwd, "prefill", k.attrs["bucket"], cfg, n_blocks)
                assert sub[3].attrs["length"] == k.attrs["prompt_len"]
            else:
                assert [s.name for s in sub] == DECODE_KIDS
                assert k.attrs["active"] == st.attrs["active"] <= SLOTS
                assert k.attrs["live_rows"] > 0
                (fwd,) = tr.children_of(sub[3])
                _check_forward(tr, fwd, "decode", SLOTS, cfg, n_blocks)
            assert all(_within(s, k) for s in sub)
    # request-level records share the request's rid
    assert sorted(by_rid) == [f"r{i}" for i in range(len(PROMPTS))]
    # the wait for admission: from the submit event to the request's own
    # prefill span, one clock, joined by rid
    submits = {e.attrs["rid"]: e for e in tr.events if e.name == "engine.submit"}
    assert [e.name for e in tr.events] == ["engine.submit"] * len(PROMPTS)
    assert sorted(submits) == sorted(by_rid)
    for rid, ev in submits.items():
        assert ev.attrs["prompt_len"] == by_rid[rid].attrs["prompt_len"]
        assert ev.duration == 0.0 and ev.time <= by_rid[rid].t_start
    first = min(steps, key=lambda s: s.t_start)
    assert max(ev.time for ev in submits.values()) <= first.t_start


@pytest.mark.parametrize("arch,bucket", [("smollm-135m", True), ("smollm-135m", False),
                                         ("xlstm-125m", True)])
def test_pad_tokens_and_counters(models, arch, bucket):
    """``pad_tokens`` = ``bucket`` - ``prompt_len``; the counters hold the
    sums.  Without bucketing, and for a recurrent arch, the bucket is the
    prompt."""
    eng = _engine(models, arch, bucket_prefill=bucket)
    with obs.enabled() as tel:
        _submit_all(eng)
        eng.run()
    spans = tel.tracer.find("engine.prefill")
    assert [s.attrs["prompt_len"] for s in spans] == list(PROMPTS)
    padded = bucket and not eng.bundle.cfg.is_recurrent
    for s in spans:
        a = s.attrs
        assert a["bucket"] == (_next_pow2(a["prompt_len"]) if padded else a["prompt_len"])
        assert a["pad_tokens"] == a["bucket"] - a["prompt_len"]
    m = tel.metrics
    assert m.get("engine_prefill_tokens_total").value == sum(s.attrs["bucket"] for s in spans)
    assert m.get("engine_prefill_pad_tokens_total").value == \
        sum(s.attrs["pad_tokens"] for s in spans)
    assert (m.get("engine_prefill_pad_tokens_total").value > 0) == padded
    text = obs.prometheus_text(m)
    assert "repro_engine_prefill_tokens_total" in text
    assert "repro_engine_prefill_pad_tokens_total" in text


@pytest.mark.parametrize("slots", [1, 3])
def test_head_rows_and_counter(models, slots):
    """A 5-token prompt padded to 8 runs the head on one row; a decode step
    over ``slots`` slots on ``slots`` rows; ``model_head_rows_total`` sums
    the ``rows`` of every ``model.head`` span."""
    mb, params = models["smollm-135m"]
    eng = Engine(mb, params, EngineConfig(max_slots=slots, max_len=64))
    with obs.enabled() as tel:
        eng.submit(Request(rid="r0", prompt=[3, 1, 4, 1, 5], max_new_tokens=3))
        eng.run()
    tr = tel.tracer
    (pre,) = tr.find("engine.prefill")
    assert (pre.attrs["prompt_len"], pre.attrs["bucket"]) == (5, 8)
    (pfwd,) = tr.children_of(_kids(tr, pre)[1])
    assert pfwd.attrs["rows"] == 8
    assert _kids(tr, pfwd)[-1].attrs == {"rows": 1}
    decodes = tr.find("engine.decode")
    assert len(decodes) == 2
    for d in decodes:
        (dfwd,) = tr.children_of(_kids(tr, d)[3])
        assert _kids(tr, dfwd)[-1].attrs == {"rows": slots}
    heads = tr.find("model.head")
    assert [h.attrs["rows"] for h in heads] == [1] + [slots] * 2
    assert tel.metrics.get("model_head_rows_total").value == 1 + 2 * slots
    assert "repro_model_head_rows_total" in obs.prometheus_text(tel.metrics)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b", "xlstm-125m"])
def test_live_and_noop_handles_serve_identical_tokens(models, arch):
    off = _served(_engine(models, arch))
    with obs.enabled() as tel:
        on = _served(_engine(models, arch))
    assert tel.tracer.spans
    assert on == off
    assert obs.get_telemetry().enabled is False


def test_noop_handle_records_nothing(models):
    tel = obs.get_telemetry()
    assert not tel.enabled
    eng = _engine(models)
    _served(eng)
    assert tel.tracer.records() == [] and tel.metrics.instruments() == []


def test_noop_handle_opens_spans_without_attributes(models, monkeypatch):
    """With the no-op handle every site passes its span's name alone: the
    attributes are built only while telemetry records."""
    from repro_torch.obs.trace import NoopTracer

    opened = []
    real = NoopTracer.span

    def span(self, name, **attrs):
        opened.append((name, attrs))
        return real(self, name, **attrs)

    monkeypatch.setattr(NoopTracer, "span", span)
    _served(_engine(models, "zamba2-1.2b"))
    names = {n for n, _ in opened}
    assert {"engine.step", "engine.prefill", "engine.decode", "kvcache.insert",
            "model.forward", "model.block", "model.head"} <= names
    assert [a for _, a in opened if a] == []


def _ancestors(ev):
    out = []
    p = ev.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_profiler_ranges_under_the_span_names_nested_as_spans(models):
    eng = _engine(models, "zamba2-1.2b")
    with obs.enabled() as tel, profile(activities=[ProfilerActivity.CPU]) as prof:
        _submit_all(eng)
        eng.run()
    spans = tel.tracer.spans
    names = {s.name for s in spans}
    ranges = [e for e in prof.events() if e.name in names]
    assert all(e.is_user_annotation for e in ranges)
    for name in names:
        assert sum(e.name == name for e in ranges) == len(tel.tracer.find(name)), name
    # each range's innermost enclosing program range is its span's parent
    by_id = {s.span_id: s for s in spans}
    want = sorted((s.name, by_id[s.parent_id].name if s.parent_id else None) for s in spans)
    got = sorted((e.name, next((a for a in _ancestors(e) if a in names), None))
                 for e in ranges)
    assert got == want


def test_no_profiler_range_without_a_recording_session(models, monkeypatch):
    import torch.profiler as tprof

    opened = []
    real = tprof.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(tprof, "record_function", counting)
    eng = _engine(models)
    with obs.enabled() as tel:
        _submit_all(eng)
        eng.step()
    assert tel.tracer.spans and opened == []
    with obs.enabled() as tel, profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    assert len(opened) == len(tel.tracer.spans) > 0


def test_span_clock_fields_and_record():
    tr = obs.Tracer()
    with tr.span("outer") as a:
        assert a.t_end is None
        with tr.span("inner") as b:
            pass
    assert a.t_start <= b.t_start <= b.t_end <= a.t_end
    assert a.duration == pytest.approx(a.t_end - a.t_start)
    rec = {r["name"]: r for r in tr.records()}
    assert rec["inner"]["t_start"] == b.t_start and rec["outer"]["t_end"] == a.t_end
    assert rec["inner"]["parent_id"] == a.span_id


def test_tracer_keeps_the_first_records_and_counts_the_rest():
    tr = obs.Tracer(max_records=2)
    for i in range(4):
        with tr.span(f"s{i}"):
            pass
        tr.event(f"e{i}", float(i))
    assert [s.name for s in tr.spans] == ["s0", "s1"]
    assert [e.name for e in tr.events] == ["e0", "e1"]
    assert tr.n_dropped == 4
