"""Port engine vs the reference engine: token-identical completions on the
same weights, slot reuse, EOS, the serve entry point, and the CUDA-by-default
rule of the entry points."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import bundle as jbundle
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig, Request as JRequest
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import bundle as tbundle
from repro_torch.serving import Engine, EngineConfig, Request


@pytest.fixture(scope="module")
def smollm():
    jcfg = reduced(get_config("smollm-135m"), capacity_factor=8.0)
    jmb = jbundle(jcfg)
    jparams = jmb.init(jax.random.key(0))
    tcfg = t_reduced(t_get_config("smollm-135m"))
    tmb = tbundle(tcfg)
    tparams = bridge.params_to_torch(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmb, jparams, tmb, tparams


def _naive_generate(mb, params, prompt, n_new):
    """Oracle: full forward over the growing sequence, greedy argmax."""
    toks = list(prompt)
    out = []
    for _ in range(n_new):
        logits, _, _ = mb.model.forward(params, {"tokens": torch.tensor([toks])})
        nxt = int(torch.argmax(logits[0, -1]))
        toks.append(nxt)
        out.append(nxt)
    return out


def _check_against_reference_engine(smollm, **engine_cfg):
    jmb, jparams, tmb, tparams = smollm
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 255, size=n))) for n in (5, 3, 7, 4)]
    jeng = JEngine(jmb, jparams, JEngineConfig(max_slots=3, max_len=64, **engine_cfg))
    teng = Engine(tmb, tparams, EngineConfig(max_slots=3, max_len=64, **engine_cfg))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=f"r{i}", prompt=p, max_new_tokens=5))
        teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=5))
    want = {c.rid: (c.tokens, c.finish_reason) for c in jeng.run()}
    got = {c.rid: (c.tokens, c.finish_reason) for c in teng.run()}
    assert got == want
    assert teng.stats == jeng.stats
    for i, p in enumerate(prompts):
        assert got[f"r{i}"][0] == _naive_generate(tmb, tparams, p, 5)


def test_engine_matches_reference_engine(smollm):
    _check_against_reference_engine(smollm)


def test_engine_exact_length_prefill_matches_reference_engine(smollm):
    """bucket_prefill=False: an attention arch prefills at the prompt's own
    length, as recurrent archs always do."""
    _check_against_reference_engine(smollm, bucket_prefill=False)


@pytest.mark.parametrize("bucket", [True, False])
def test_engine_prefill_names_the_last_true_position(smollm, monkeypatch, bucket):
    """Every prefill's batch carries "logit_positions" [[plen - 1]] and gets
    the logits of that one row, (1, 1, V); the completions still equal the
    reference engine's."""
    jmb, jparams, tmb, tparams = smollm
    seen = []
    real = tmb.prefill_fn

    def spy(params, batch, max_len):
        logits, cache = real(params, batch, max_len=max_len)
        seen.append((batch["logit_positions"].tolist(), tuple(logits.shape)))
        return logits, cache

    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 255, size=n))) for n in (5, 3, 8, 6)]
    jeng = JEngine(jmb, jparams, JEngineConfig(max_slots=2, max_len=64, bucket_prefill=bucket))
    teng = Engine(tmb, tparams, EngineConfig(max_slots=2, max_len=64, bucket_prefill=bucket))
    monkeypatch.setattr(teng, "bundle", type("B", (), {"prefill_fn": staticmethod(spy)})())
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=f"r{i}", prompt=p, max_new_tokens=4))
        teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=4))
    want = {c.rid: (c.tokens, c.finish_reason) for c in jeng.run()}
    got = {c.rid: (c.tokens, c.finish_reason) for c in teng.run()}
    assert got == want
    vocab = tmb.cfg.vocab_size
    assert seen == [([[len(p) - 1]], (1, 1, vocab)) for p in prompts]


def test_engine_slot_reuse_and_stats(smollm):
    _, _, mb, params = smollm
    eng = Engine(mb, params, EngineConfig(max_slots=2, max_len=32))
    for i in range(5):
        eng.submit(Request(rid=f"q{i}", prompt=[1 + i, 2, 3], max_new_tokens=3))
    done = eng.run()
    assert len(done) == 5
    assert eng.stats["prefills"] == 5
    assert eng.n_active == 0 and not eng.queue
    # 5 requests through 2 slots => slots were recycled
    assert eng.stats["tokens"] == sum(len(c.tokens) for c in done)


def test_engine_eos_stops_early(smollm):
    _, _, mb, params = smollm
    # discover what token the model greedily emits, then use it as EOS
    probe = _naive_generate(mb, params, [5, 6, 7], 1)[0]
    eng = Engine(mb, params, EngineConfig(max_slots=1, max_len=32))
    eng.submit(Request(rid="e", prompt=[5, 6, 7], max_new_tokens=8, eos_id=probe))
    done = eng.run()
    assert done[0].finish_reason == "eos"
    assert done[0].tokens[-1] == probe and len(done[0].tokens) < 8


def test_engine_rejects_requests_past_max_len(smollm):
    _, _, mb, params = smollm
    eng = Engine(mb, params, EngineConfig(max_slots=1, max_len=16))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid="x", prompt=list(range(1, 13)), max_new_tokens=5))


def test_serve_runs_on_cpu(capsys):
    ops.reset_launch_counts()
    assert serve.main(["--device", "cpu", "--reduced", "--requests", "6", "--slots", "2",
                       "--max-len", "64", "--max-new", "6"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("6 completions") and "prefills" in out
    assert ops.launch_counts() == {}  # the CPU path never reaches a kernel


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch, smollm):
    jmb, jparams, tmb, _ = smollm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmb.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmb.model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1"])
