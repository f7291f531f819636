"""Port zamba2 (Mamba-2 blocks + a weight-shared attention block) vs the
reference: the weight bridge and its f32 leaves, parameter counts, the
cache layout, reduced prefill and ragged-decode logits on the same weights
(f32, CPU), and the continuous-batching engine token for token."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import bundle as jbundle
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig, Request as JRequest
from repro.serving.kvcache import insert_prefix as j_insert_prefix
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import bundle as tbundle
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.serving.kvcache import insert_prefix, live_kv_bytes

# f32 on the CPU in both frameworks: the same math summed in another order;
# observed differences are ~5e-6, the bound leaves more than an order of
# magnitude.
TOL = dict(atol=1e-4, rtol=1e-4)
#: the default reduced zamba2 (2 layers, one shared application) and a
#: deeper one: groups of 2, 2, 1 with two shared applications
VARIANTS = {"2L": {}, "5L": dict(n_layers=5, shared_attn_every=2)}


def _pair(over, dtype="float32", seed=0):
    jmb = jbundle(reduced(get_config("zamba2-1.2b"), dtype=dtype, **over))
    jparams = jmb.init(jax.random.key(seed))
    tmb = tbundle(t_reduced(t_get_config("zamba2-1.2b"), dtype=dtype, **over))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg, device="cpu")
    return jmb, jparams, tmb, tparams


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def zamba(request):
    return _pair(VARIANTS[request.param])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")}
    if isinstance(tree, (list, tuple)):
        return {p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")}
    return {prefix}


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(1, 255, size=(b, s))


def test_groups_split_at_shared_attention_like_reference(zamba):
    jmb, _, tmb, _ = zamba
    assert tmb.model._groups() == jmb.model._groups()
    assert tmb.model.n_shared_apps == jmb.model.n_shared_apps
    full_t, full_j = tbundle(t_get_config("zamba2-1.2b")).model, jbundle(
        get_config("zamba2-1.2b")).model
    assert full_t._groups() == full_j._groups() == (("mamba2", 6),) * 6 + (("mamba2", 2),)
    assert full_t.n_shared_apps == full_j.n_shared_apps == 6


def test_bridge_maps_every_leaf_exactly(zamba):
    jmb, jparams, tmb, tparams = zamba
    jp = jax.tree.map(np.asarray, jparams)
    assert _paths(jp) == _paths(tparams)
    for path in _paths(jp):
        np.testing.assert_array_equal(_get(tparams, path).numpy(), _get(jp, path))
    fresh = tmb.init(torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(_get(fresh, p).shape) for p in _paths(fresh)} == \
        {p: _get(jp, p).shape for p in _paths(jp)}


def test_f32_leaves_stay_f32_in_a_bf16_model():
    jmb, jparams, tmb, tparams = _pair({}, dtype="bfloat16", seed=1)
    fresh = tmb.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = tmb.param_shapes()
    jp = jax.tree.map(np.asarray, jparams)
    for path in _paths(jp):
        want = str(_get(jp, path).dtype)
        for tree in (tparams, fresh, shapes):
            assert str(_get(tree, path).dtype).split(".")[-1] == want, path
    mixer = tparams["groups"][0]["mixer"]
    assert {k: mixer[k].dtype for k in ("a_log", "dt_bias", "d_skip", "w_in")} == {
        "a_log": torch.float32, "dt_bias": torch.float32, "d_skip": torch.float32,
        "w_in": torch.bfloat16}


def test_param_count_matches_reference_at_full_width():
    t = tbundle(t_get_config("zamba2-1.2b"))
    n = t.param_count()
    assert n == jbundle(get_config("zamba2-1.2b")).param_count() == 1_151_042_112


def test_cache_layout_matches_reference(zamba):
    jmb, _, tmb, _ = zamba
    jc = jmb.model.init_cache(3, 32, ragged=True)
    tc = tmb.model.init_cache(3, 32, ragged=True, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jc)
    assert _paths(tc) == {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}" for k in p)
                          for p, _ in jl}
    for p, leaf in jl:
        path = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}" for k in p)
        t = _get(tc, path)
        assert tuple(t.shape) == leaf.shape and str(t.dtype).split(".")[-1] == str(leaf.dtype)
    assert live_kv_bytes(tc) == sum(x.size * x.dtype.itemsize for _, x in jl)


def test_prefill_and_ragged_decode_logits_match_reference(zamba):
    jmb, jparams, tmb, tparams = zamba
    B, P, max_len = 3, 9, 32
    toks = _tokens(2, B, P)
    lj, cj = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=max_len)
    lt, ct = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(ct["groups"][-1]["mixer"][name].numpy(),
                                   np.asarray(cj["groups"][-1]["mixer"][name]), **TOL)
    np.testing.assert_allclose(ct["shared"]["attn"]["k"].numpy(),
                               np.asarray(cj["shared"]["attn"]["k"]), **TOL)
    # uniform decode step
    nxt = _tokens(3, B, 1)
    dj, _ = jmb.decode_fn(jparams, cj, jnp.asarray(nxt, jnp.int32), jnp.int32(P))
    dt, _ = tmb.decode_fn(tparams, ct, torch.from_numpy(nxt), torch.tensor(P))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    # ragged decode step: slots hold prompts of different true lengths,
    # each prefilled at its exact length (no padding through the recurrence)
    lens = [9, 4, 6]
    cache_j = jmb.model.init_cache(B, max_len, ragged=True)
    cache_t = tmb.model.init_cache(B, max_len, ragged=True, device="cpu")
    for b, n in enumerate(lens):
        _, pj = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(toks[b:b + 1, :n], jnp.int32)},
                               max_len=max_len)
        cache_j = j_insert_prefix(cache_j, pj, jnp.int32(b), jnp.int32(n))
        _, pt = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(toks[b:b + 1, :n])},
                               max_len=max_len)
        insert_prefix(cache_t, pt, b, n)
    pos = np.asarray(lens, np.int32)
    rj, cache_j, _ = jmb.model.forward(jparams, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                       cache=cache_j, positions=jnp.asarray(pos)[:, None])
    rt, cache_t, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(nxt)}, cache=cache_t,
                                    positions=torch.from_numpy(pos)[:, None])
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
    np.testing.assert_array_equal(cache_t["shared"]["attn"]["index"].numpy(),
                                  np.asarray(cache_j["shared"]["attn"]["index"]))
    np.testing.assert_allclose(cache_t["groups"][0]["mixer"]["ssm"].numpy(),
                               np.asarray(cache_j["groups"][0]["mixer"]["ssm"]), **TOL)


def test_engine_matches_reference_engine(zamba):
    jmb, jparams, tmb, tparams = zamba
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 255, size=n))) for n in (5, 3, 7, 4, 9)]
    jeng = JEngine(jmb, jparams, JEngineConfig(max_slots=3, max_len=64))
    teng = Engine(tmb, tparams, EngineConfig(max_slots=3, max_len=64))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=f"r{i}", prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6))
    want = {c.rid: (c.tokens, c.finish_reason) for c in jeng.run()}
    got = {c.rid: (c.tokens, c.finish_reason) for c in teng.run()}
    assert got == want
    assert teng.stats == jeng.stats
    np.testing.assert_array_equal(teng._slot_indexes(), jeng._slot_indexes())


def test_engine_prefills_recurrent_prompts_at_their_exact_length(zamba, monkeypatch):
    _, _, tmb, tparams = zamba
    seen = []
    real = tmb.prefill_fn

    def spy(params, batch, max_len):
        seen.append(batch["tokens"].shape[1])
        return real(params, batch, max_len=max_len)

    eng = Engine(tmb, tparams, EngineConfig(max_slots=2, max_len=32))
    monkeypatch.setattr(eng, "bundle", type("B", (), {"prefill_fn": staticmethod(spy)})())
    for i, n in enumerate((5, 3, 7)):
        eng.submit(Request(rid=f"q{i}", prompt=list(range(1, n + 1)), max_new_tokens=2))
    eng.run()
    assert seen == [5, 3, 7]


def test_serve_runs_zamba2_on_cpu(capsys):
    ops.reset_launch_counts()
    assert serve.main(["--arch", "zamba2-1.2b", "--device", "cpu", "--reduced", "--requests",
                       "4", "--slots", "2", "--max-len", "64", "--max-new", "5"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("4 completions") and "prefills" in out
    assert ops.launch_counts() == {}  # the CPU path never reaches a kernel
