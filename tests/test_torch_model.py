"""Port model vs the reference: the weight bridge, parameter counts, and
reduced smollm-135m logits on the same weights (f32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import bundle as jbundle
from repro.serving.kvcache import insert_prefix as j_insert_prefix
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.models import bundle as tbundle
from repro_torch.tree import tree_leaves
from repro_torch.serving.kvcache import insert_prefix, live_kv_bytes

# f32 on the CPU in both frameworks: the same math summed in another order
# (XLA vs ATen GEMMs and reductions) through a 2-layer model; observed
# differences are ~1e-6, the bound leaves two orders of magnitude.
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def smollm():
    jcfg = reduced(get_config("smollm-135m"))
    jmb = jbundle(jcfg)
    jparams = jmb.init(jax.random.key(0))
    tcfg = t_reduced(t_get_config("smollm-135m"))
    tmb = tbundle(tcfg)
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmb, jparams, tmb, tparams


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


def test_bridge_maps_every_leaf_exactly(smollm):
    jmb, jparams, tmb, tparams = smollm
    jp = jax.tree.map(np.asarray, jparams)
    assert _paths(jp) == _paths(tparams)
    for path in _paths(jp):
        np.testing.assert_array_equal(_get(tparams, path).numpy(), _get(jp, path))
    # the port's own init builds the same tree
    fresh = tmb.init(torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(_get(fresh, p).shape) for p in _paths(fresh)} == \
        {p: _get(jp, p).shape for p in _paths(jp)}


def test_bridge_bf16_leaves_are_exact():
    cfg = reduced(get_config("smollm-135m"), dtype="bfloat16")
    jparams = jbundle(cfg).init(jax.random.key(1))
    tcfg = t_reduced(t_get_config("smollm-135m"), dtype="bfloat16")
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    wq = tparams["groups"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(jparams["groups"][0]["attn"]["wq"], np.float32))


def test_bridge_rejects_mismatched_trees(smollm):
    jmb, jparams, tmb, _ = smollm
    jp = jax.tree.map(np.asarray, jparams)
    cfg = tmb.cfg
    missing = {**jp, "ln_f": {}}
    with pytest.raises(ValueError, match="ln_f/scale"):
        params_to_torch(missing, cfg, device="cpu")
    extra = {**jp, "lm_head": jp["embedding"].T}
    with pytest.raises(ValueError, match="lm_head"):
        params_to_torch(extra, cfg, device="cpu")
    g0 = jp["groups"][0]
    wrong = {**jp, "groups": [{**g0, "mlp": {**g0["mlp"],
                                             "w_out": np.swapaxes(g0["mlp"]["w_out"], 1, 2)}}]}
    with pytest.raises(ValueError, match="w_out"):
        params_to_torch(wrong, cfg, device="cpu")


def test_logits_catch_a_transposed_square_weight(smollm):
    """wq is square at reduced width (64 x 64), so shapes cannot catch a
    missing transpose; the logits comparison must."""
    jmb, jparams, tmb, tparams = smollm
    toks = _tokens(1, 2, 9)
    want = np.asarray(jmb.model.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})[0])
    g0 = tparams["groups"][0]
    assert g0["attn"]["wq"].shape[1:] == (64, 64)
    bad = {**tparams, "groups": [{**g0, "attn": {**g0["attn"],
                                                  "wq": g0["attn"]["wq"].transpose(1, 2)}}]}
    got_bad = tmb.model.forward(bad, {"tokens": torch.from_numpy(toks)})[0].numpy()
    assert not np.allclose(got_bad, want, **TOL)


def test_param_count_matches_reference_at_full_width():
    t = tbundle(t_get_config("smollm-135m"))
    assert all(p.device.type == "meta" for p in tree_leaves(t.param_shapes()))
    n = t.param_count()
    assert n == jbundle(get_config("smollm-135m")).param_count() == 134_515_008


def test_prefill_and_ragged_decode_logits_match_reference(smollm):
    jmb, jparams, tmb, tparams = smollm
    B, P, max_len = 3, 6, 32
    toks = _tokens(2, B, P)
    lj, cj = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=max_len)
    lt, ct = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct["groups"][0]["attn"][name].numpy(),
                                   np.asarray(cj["groups"][0]["attn"][name]), **TOL)
    # one ragged decode step: slots hold prompts of different true lengths
    lens = [6, 3, 5]
    cache_j = jmb.model.init_cache(B, max_len, ragged=True)
    cache_t = tmb.model.init_cache(B, max_len, ragged=True, device="cpu")
    for b, n in enumerate(lens):
        _, pj = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(toks[b:b + 1], jnp.int32)},
                               max_len=max_len)
        cache_j = j_insert_prefix(cache_j, pj, jnp.int32(b), jnp.int32(n))
        _, pt = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(toks[b:b + 1])},
                               max_len=max_len)
        insert_prefix(cache_t, pt, b, n)
    nxt = _tokens(3, B, 1)
    pos = np.asarray(lens, np.int32)
    dj, cache_j, _ = jmb.model.forward(jparams, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                       cache=cache_j, positions=jnp.asarray(pos)[:, None])
    dt, cache_t, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(nxt)}, cache=cache_t,
                                    positions=torch.from_numpy(pos)[:, None])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    np.testing.assert_array_equal(cache_t["groups"][0]["attn"]["index"].numpy(),
                                  np.asarray(cache_j["groups"][0]["attn"]["index"]))
    assert live_kv_bytes(cache_t) == sum(
        x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(cache_j))


def test_ragged_equals_uniform_when_lengths_equal(smollm):
    """All slots at the same position: ragged decode == uniform decode_fn."""
    _, _, mb, params = smollm
    B, P = 3, 6
    toks = torch.from_numpy(_tokens(4, B, P))
    # uniform path
    logits_u, cache_u = mb.prefill_fn(params, {"tokens": toks}, max_len=32)
    nxt_u = torch.argmax(logits_u[:, -1], -1)
    logits2_u, _ = mb.decode_fn(params, cache_u, nxt_u[:, None], torch.tensor(P))
    # ragged path
    cache_r = mb.model.init_cache(B, 32, ragged=True, device="cpu")
    for b in range(B):
        _, pref = mb.prefill_fn(params, {"tokens": toks[b:b + 1]}, max_len=32)
        insert_prefix(cache_r, pref, b, P)
    lengths = torch.full((B,), P, dtype=torch.int32)
    logits2_r, _, _ = mb.model.forward(params, {"tokens": nxt_u[:, None]}, cache=cache_r,
                                    positions=lengths[:, None])
    np.testing.assert_allclose(logits2_r.numpy(), logits2_u.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", [
    "mistral-large-123b",  # rope_theta 1e6
    "nemotron-4-340b",  # layernorm, squared-ReLU MLP
    "chatglm3-6b",  # half-rotary RoPE
])
def test_other_dense_archs_match_reference(name):
    """The other dense GQA configs the port accepts: prefill logits and one
    uniform decode step against the reference on bridged weights."""
    jmb = jbundle(reduced(get_config(name)))
    jparams = jmb.init(jax.random.key(3))
    tmb = tbundle(t_reduced(t_get_config(name)))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg, device="cpu")
    toks = _tokens(5, 2, 7)
    lj, cj = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=16)
    lt, ct = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)}, max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    nxt = _tokens(6, 2, 1)
    dj, _ = jmb.decode_fn(jparams, cj, jnp.asarray(nxt, jnp.int32), jnp.int32(7))
    dt, _ = tmb.decode_fn(tparams, ct, torch.from_numpy(nxt), torch.tensor(7))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
