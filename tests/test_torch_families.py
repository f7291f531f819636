"""The four families beyond dense GQA, Mamba-2 and xLSTM, held to the
reference on bridged weights at ``reduced()`` size (f32, CPU):

  * mixtral-8x7b: MoE FFN and the sliding-window ring cache (wrapping in
    decode; prefill of s >= Smax rows; the padded-ring behaviour kept for
    parity, see ROADMAP queue C);
  * deepseek-v3-671b: MLA with its latent cache, dense leading layers and an
    MoE of routed and shared experts;
  * pixtral-12b: projected patch embeddings spliced over the first tokens;
  * seamless-m4t-large-v2: encoder over frames and cross-attention from a
    precomputed cross cache.

Each: prefill logits, uniform and ragged decode, and the continuous-batching
engine token for token, with ``extras`` where the family takes them."""
import importlib.util
import pathlib

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

# f32 on the CPU in both frameworks: the same math summed in another order
# (XLA vs ATen GEMMs and reductions) through 2-layer models; observed
# differences are ~3e-6, the bound leaves more than an order of magnitude.
TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["mixtral-8x7b", "deepseek-v3-671b", "pixtral-12b", "seamless-m4t-large-v2"]
#: a ring of 8 rows, small enough that short prompts wrap it; capacity for
#: every token, so that a forward over S tokens and a prefill of S - 1 and a
#: decode step route alike (the MoE drops tokens by batch size)
RING = dict(sliding_window=8, capacity_factor=8.0)


def _pair(name, seed=0, **over):
    jmb = jbundle(reduced(get_config(name), **over))
    jparams = jmb.init(jax.random.key(seed))
    tmb = tbundle(t_reduced(t_get_config(name), **over))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg, device="cpu")
    return jmb, jparams, tmb, tparams


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def ring():
    return _pair("mixtral-8x7b", seed=1, **RING)


def _extras(cfg, b, seed):
    """Seeded frontend inputs, numpy f32: (b, frontend_len, frontend_dim)."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.frontend_len, cfg.frontend_dim)
    if cfg.frontend == "vit":
        return {"patch_embeds": (rng.standard_normal(shape) * 0.1).astype(np.float32)}
    if cfg.enc_dec:
        return {"frames": (rng.standard_normal(shape) * 0.1).astype(np.float32)}
    return {}


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(1, 255, size=(b, s))


def _batches(cfg, toks, seed=11):
    ex = _extras(cfg, toks.shape[0], seed)
    jb = {"tokens": jnp.asarray(toks, jnp.int32), **{k: jnp.asarray(v) for k, v in ex.items()}}
    tb = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in ex.items()}}
    return jb, tb


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_caches_equal(tc, jc):
    tl, jl = _leaves(tc), _leaves(jc)
    assert tl.keys() == jl.keys()
    for path in tl:
        np.testing.assert_allclose(tl[path].numpy(), np.asarray(jl[path]), **TOL, err_msg=path)
    assert live_kv_bytes(tc) == sum(x.size * x.dtype.itemsize
                                    for x in jax.tree_util.tree_leaves(jc))


def test_prefill_and_uniform_decode_match_reference(family):
    jmb, jparams, tmb, tparams = family
    toks = _tokens(1, 2, 11)
    jb, tb = _batches(jmb.cfg, toks)
    lj, cj = jmb.prefill_fn(jparams, jb, max_len=16)
    lt, ct = tmb.prefill_fn(tparams, tb, max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_caches_equal(ct, cj)
    nxt = _tokens(2, 2, 1)
    for step in range(3):
        dj, cj = jmb.decode_fn(jparams, cj, jnp.asarray(nxt, jnp.int32), jnp.int32(11 + step))
        dt, ct = tmb.decode_fn(tparams, ct, torch.from_numpy(nxt), torch.tensor(11 + step))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
        nxt = np.array(jnp.argmax(dj, -1))
    _assert_caches_equal(ct, cj)


def test_ragged_decode_matches_reference(family):
    """Slots of different true lengths, each prefilled at batch 1 (with its
    own extras) and inserted into a ragged cache; one decode step."""
    jmb, jparams, tmb, tparams = family
    B, P, max_len = 3, 7, 16
    lens = [7, 3, 5]
    toks = _tokens(3, B, P)
    cache_j = jmb.model.init_cache(B, max_len, jmb.cfg.frontend_len if jmb.cfg.enc_dec else 0,
                                   ragged=True)
    cache_t = tmb.model.init_cache(B, max_len, tmb.cfg.frontend_len if tmb.cfg.enc_dec else 0,
                                   ragged=True, device="cpu")
    for b, n in enumerate(lens):
        jb, tb = _batches(jmb.cfg, toks[b:b + 1], seed=20 + b)
        _, pj = jmb.prefill_fn(jparams, jb, max_len=max_len)
        cache_j = j_insert_prefix(cache_j, pj, jnp.int32(b), jnp.int32(n))
        _, pt = tmb.prefill_fn(tparams, tb, max_len=max_len)
        insert_prefix(cache_t, pt, b, n)
    _assert_caches_equal(cache_t, cache_j)
    nxt = _tokens(4, B, 1)
    pos = np.asarray(lens, np.int32)
    dj, cache_j, _ = jmb.model.forward(jparams, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                       cache=cache_j, positions=jnp.asarray(pos)[:, None])
    dt, cache_t, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(nxt)}, cache=cache_t,
                                    positions=torch.from_numpy(pos)[:, None])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    _assert_caches_equal(cache_t, cache_j)


def test_ring_wraps_in_decode(ring):
    """A 5-token prompt in a ring of 8 rows, then 9 decode steps: the ring
    wraps at the fourth and every row is attended to from then on."""
    jmb, jparams, tmb, tparams = ring
    toks = _tokens(5, 2, 5)
    jb, tb = _batches(jmb.cfg, toks)
    _, cj = jmb.prefill_fn(jparams, jb, max_len=32)
    _, ct = tmb.prefill_fn(tparams, tb, max_len=32)
    assert ct["groups"][0]["attn"]["k"].shape[2] == 8  # min(max_len, window)
    nxt = _tokens(6, 2, 1)
    for step in range(9):
        dj, cj = jmb.decode_fn(jparams, cj, jnp.asarray(nxt, jnp.int32), jnp.int32(5 + step))
        dt, ct = tmb.decode_fn(tparams, ct, torch.from_numpy(nxt), torch.tensor(5 + step))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
        nxt = np.array(jnp.argmax(dj, -1))
    _assert_caches_equal(ct, cj)
    assert int(ct["groups"][0]["attn"]["index"][0]) == 14


@pytest.mark.parametrize("s", [8, 11, 16])
def test_ring_prefill_of_at_least_smax_rows(ring, s):
    """s >= Smax unpadded: the last Smax rows, rolled by s % Smax, and the
    decode step after it equals the full forward over s + 1 tokens."""
    jmb, jparams, tmb, tparams = ring
    toks = _tokens(7, 1, s + 1)
    jb, tb = _batches(jmb.cfg, toks[:, :s])
    _, cj = jmb.prefill_fn(jparams, jb, max_len=32)
    _, ct = tmb.prefill_fn(tparams, tb, max_len=32)
    _assert_caches_equal(ct, cj)
    dt, _ = tmb.decode_fn(tparams, ct, torch.from_numpy(toks[:, s:]), torch.tensor(s))
    full, _, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(dt[:, 0].numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("n", [7, 9, 12])
def test_padded_ring_prefill_keeps_the_references_behaviour(ring, n):
    """The reference's padded ring (ROADMAP queue C): an n-token prompt
    right-padded to 16 rows for a ring of 8 keeps the last 8 rows of the
    padded block, so padding displaces real tokens.  Both packages give the
    same decode logits, and both differ from the unpadded forward."""
    jmb, jparams, tmb, tparams = ring
    toks = _tokens(8, 1, n + 1)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :n] = toks[0, :n]
    outs = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            cache = jmb.model.init_cache(1, 32, ragged=True)
            _, pre = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(padded, jnp.int32)},
                                    max_len=32)
            cache = j_insert_prefix(cache, pre, jnp.int32(0), jnp.int32(n))
            lg, _, _ = jmb.model.forward(jparams, {"tokens": jnp.asarray(toks[:, n:], jnp.int32)},
                                         cache=cache, positions=jnp.asarray([[n]], jnp.int32))
            outs.append(np.asarray(lg[:, 0]))
        else:
            cache = tmb.model.init_cache(1, 32, ragged=True, device="cpu")
            _, pre = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(padded)}, max_len=32)
            insert_prefix(cache, pre, 0, n)
            lg, _, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(toks[:, n:])},
                                      cache=cache, positions=torch.tensor([[n]]))
            outs.append(lg[:, 0].numpy())
    ref_out, port_out = outs
    np.testing.assert_allclose(port_out, ref_out, **TOL)
    full, _, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert np.abs(port_out - full[:, -1].numpy()).max() > 1e-2


def test_mla_cache_is_latent_and_never_int8(family):
    jmb, _, tmb, _ = family
    from repro_torch.models import layers

    layers.set_kv_quant(True)
    try:
        cache = tmb.model.init_cache(2, 16, 8, ragged=True, device="cpu")
    finally:
        layers.set_kv_quant(False)
    attn = cache["groups"][0]["attn"]
    cfg = tmb.cfg
    if cfg.attention == "mla":
        assert set(attn) == {"c_kv", "k_pe", "index"}
        assert attn["c_kv"].shape[-1] == cfg.kv_lora_rank
        assert attn["k_pe"].shape[-1] == cfg.qk_rope_head_dim
    elif cfg.sliding_window:
        assert set(attn) == {"k", "v", "index"}  # a ring never quantizes
    else:
        assert attn["k"].dtype == torch.int8
    assert ("cross" in cache) == cfg.enc_dec


def test_cross_cache_is_inserted_into_its_slot():
    """Seamless: a batch-1 prefill's cross K/V land in slot 1 of the
    decode cache, the other slots untouched, as in the reference."""
    jmb, jparams, tmb, tparams = _pair("seamless-m4t-large-v2", seed=2)
    enc = tmb.cfg.frontend_len
    jb, tb = _batches(jmb.cfg, _tokens(9, 1, 6), seed=5)
    _, pj = jmb.prefill_fn(jparams, jb, max_len=16)
    _, pt = tmb.prefill_fn(tparams, tb, max_len=16)
    cache_j = j_insert_prefix(jmb.model.init_cache(3, 16, enc, ragged=True), pj,
                              jnp.int32(1), jnp.int32(6))
    cache_t = insert_prefix(tmb.model.init_cache(3, 16, enc, ragged=True, device="cpu"), pt,
                            1, 6)
    assert cache_t["cross"]["k"].shape == (tmb.cfg.n_layers, 3, enc, tmb.cfg.n_kv_heads,
                                           tmb.cfg.head_dim_)
    _assert_caches_equal(cache_t, cache_j)
    for name in ("k", "v"):
        assert cache_t["cross"][name][:, 1].abs().sum() > 0
        assert not cache_t["cross"][name][:, [0, 2]].any()


def test_vlm_splice_with_fewer_tokens_than_patches():
    """Pixtral: 5 tokens against 8 patches -- the projected patches replace
    all 5 positions, as the reference splices min(n_patches, S)."""
    jmb, jparams, tmb, tparams = _pair("pixtral-12b", seed=3)
    assert tmb.cfg.frontend_len == 8
    toks = _tokens(10, 2, 5)
    jb, tb = _batches(jmb.cfg, toks, seed=6)
    lj, _ = jmb.prefill_fn(jparams, jb, max_len=16)
    lt, _ = tmb.prefill_fn(tparams, tb, max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # no token embedding reaches the output: other tokens, the same logits
    lt2, _ = tmb.prefill_fn(tparams, {**tb, "tokens": torch.from_numpy(toks[::-1].copy())},
                            max_len=16)
    np.testing.assert_allclose(lt2.numpy(), lt.numpy(), atol=1e-6)


@pytest.mark.parametrize("name,over", [("mixtral-8x7b", dict(sliding_window=16)),
                                       ("deepseek-v3-671b", {}), ("pixtral-12b", {}),
                                       ("seamless-m4t-large-v2", {})])
def test_engine_matches_reference_engine(name, over):
    """Continuous batching over 5 requests on 3 slots, token for token.
    Mixtral's ring of 16 rows wraps during decode, and its 20-token prompt
    takes the padded-ring path (bucket 32); Pixtral's and Seamless's
    requests carry their extras."""
    jmb, jparams, tmb, tparams = _pair(name, seed=4, **over)
    rng = np.random.default_rng(0)
    lens = (5, 3, 12, 9, 20) if name == "mixtral-8x7b" else (5, 3, 7, 4, 9)
    prompts = [list(map(int, rng.integers(1, 255, size=n))) for n in lens]
    jeng = JEngine(jmb, jparams, JEngineConfig(max_slots=3, max_len=48))
    teng = Engine(tmb, tparams, EngineConfig(max_slots=3, max_len=48))
    for i, p in enumerate(prompts):
        ex = _extras(jmb.cfg, 1, 30 + i)
        jeng.submit(JRequest(rid=f"r{i}", prompt=p, max_new_tokens=10, extras=ex))
        teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=10, extras=ex))
    want = {c.rid: (c.tokens, c.finish_reason) for c in jeng.run()}
    ops.reset_launch_counts()
    got = {c.rid: (c.tokens, c.finish_reason) for c in teng.run()}
    assert got == want
    assert teng.stats == jeng.stats
    assert ops.launch_counts() == {}  # the CPU path never reaches a kernel
    np.testing.assert_array_equal(teng._slot_indexes(), jeng._slot_indexes())


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_runs_the_family_on_cpu(name, capsys):
    assert serve.main(["--arch", name, "--device", "cpu", "--reduced", "--requests", "3",
                       "--slots", "2", "--max-len", "64", "--min-new", "2", "--max-new", "4"]) == 0
    assert capsys.readouterr().out.startswith("3 completions")


def _chip_smoke():
    """chip_smoke.py at the repository's root: the witnesses below take phase
    10's cuts, inputs and comparison runs from it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()


def _jax_tree(tree, cast):
    """The port's parameter tree (the reference's layout) as jax arrays:
    bf16 leaves cast to ``cast``, f32 leaves (the router) kept."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v, cast) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v, cast) for v in tree]
    arr = jnp.asarray(tree.float().cpu().numpy())
    return arr.astype(cast) if tree.dtype == torch.bfloat16 else arr


def _reference_runs(name, params, extras, prompts, plen, outs):
    """The reference's f32 and bf16 prefill and decode step on the port's
    weights and extras, for each prompt, into ``outs``."""
    import dataclasses

    max_len = smoke.VS_CPU_MAX_LEN
    for key, dtype in (("ref f32", jnp.float32), ("ref bf16", jnp.bfloat16)):
        jmb = jbundle(dataclasses.replace(get_config(name), dtype=str(jnp.dtype(dtype)),
                                          **smoke.FAMILY_VS_CPU[name]))
        jp = _jax_tree(params, dtype)
        jex = {k: jnp.asarray(v.float().cpu().numpy()).astype(dtype) for k, v in extras.items()}
        prefill = jax.jit(lambda p, b: jmb.prefill_fn(p, b, max_len=max_len))
        decode = jax.jit(jmb.decode_fn)
        for out, prompt in zip(outs, prompts):
            lg, cache = prefill(jp, {"tokens": jnp.asarray([prompt], jnp.int32), **jex})
            dg, _ = decode(jp, cache, jnp.asarray(out["nxt"].numpy(), jnp.int32),
                           jnp.int32(plen))
            out[key] = (np.asarray(lg, np.float32), np.asarray(dg, np.float32))
        del jp, cache


def _bf16_readings(name, seed, prompt_seeds):
    """chip_smoke.py phase 10's comparison (smoke.vs_cpu_case: the
    FAMILY_VS_CPU cut, bf16 weights from a cuda Generator seeded ``seed``,
    its extras) for each prompt of ``prompt_seeds``: the port's card bf16,
    free-running and with the CPU f32 run's routing, against its CPU f32,
    beside the reference's own bf16 against its f32 (JAX on the host CPU,
    jitted) on the same values.  Returns one readings dict per prompt."""
    import dataclasses

    from repro_torch.tree import tree_map

    mb, params, extras, plen = smoke.vs_cpu_case(torch, tbundle, name, seed)
    max_len = smoke.VS_CPU_MAX_LEN
    prompts = [smoke.vs_cpu_prompt(mb.cfg.vocab_size, plen, p) for p in prompt_seeds]
    mb32 = tbundle(dataclasses.replace(mb.cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float().cpu(), params)
    ex32 = {k: v.float().cpu() for k, v in extras.items()}
    outs = [{} for _ in prompts]
    for out, prompt in zip(outs, prompts):
        routes = []
        with smoke.moe_routes(routes):
            lf, df, nxt = smoke.prefill_and_step(torch, mb32, params32, prompt, ex32, max_len,
                                                 "cpu")
        out["port f32"], out["nxt"] = (lf, df), nxt
        out["port bf16"] = smoke.prefill_and_step(torch, mb, params, prompt, extras, max_len,
                                                  "cuda", nxt)[:2]
        with smoke.moe_routes(routes, replay=True):
            out["port bf16 f32-routed"] = smoke.prefill_and_step(
                torch, mb, params, prompt, extras, max_len, "cuda", nxt)[:2]
    del params32
    with jax.default_device(jax.devices("cpu")[0]):  # the card would take TF32 for f32
        _reference_runs(name, params, extras, prompts, plen, outs)

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.abs(a - b).max() / np.abs(b).max())

    readings = []
    for out in outs:
        r = {}
        for i, label in enumerate(("prefill", "decode")):
            r[label] = {
                "reference_bf16_vs_f32": rel(out["ref bf16"][i], out["ref f32"][i]),
                "port_card_bf16_vs_cpu_f32": rel(out["port bf16"][i], out["port f32"][i]),
                "port_card_bf16_f32_routed_vs_cpu_f32": rel(out["port bf16 f32-routed"][i],
                                                            out["port f32"][i]),
                "port_card_bf16_vs_reference_bf16": rel(out["port bf16"][i], out["ref bf16"][i]),
                "port_cpu_f32_vs_reference_f32": rel(out["port f32"][i], out["ref f32"][i]),
            }
        readings.append(r)
    return readings


def _assert_arithmetic(r):
    """The port's f32 is the reference's, and its bf16 with the experts
    pinned is rounding alone: two draws of bf16 noise of one size, within
    half again of each other (or of chip_smoke's ENGINE_REL_TOL)."""
    for label, x in r.items():
        assert x["port_cpu_f32_vs_reference_f32"] <= smoke.ENGINE_F32_REL_TOL, (label, x)
        assert x["port_card_bf16_f32_routed_vs_cpu_f32"] <= max(
            smoke.ENGINE_REL_TOL, 1.5 * x["reference_bf16_vs_f32"]), (label, x)


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_error_at_chip_smoke_weights_is_the_references(name):
    """chip_smoke.py phase 10's own draw (weights seeded 0, prompt seeded 7):
    the readings as one JSON line (run with -s); the arithmetic holds, and
    the free-running bf16 readings that chip_smoke.py gates stay within its
    ENGINE_REL_TOL (which it leaves ungated: the spread test below)."""
    import json

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py's weights come from a cuda Generator)")
    (r,) = _bf16_readings(name, 0, [7])
    print(json.dumps({"bf16_witness": name, "readings": r}))
    _assert_arithmetic(r)
    for label, x in r.items():
        if label not in smoke.BF16_FREE_RUN_UNGATED.get(name, ()):
            assert x["port_card_bf16_vs_cpu_f32"] <= smoke.ENGINE_REL_TOL, (label, x)


#: the MoE families' spread: weights seeds x prompt seeds (chip_smoke.py's
#: own draw is weights 0, prompt 7)
SPREAD_SEEDS, SPREAD_PROMPTS = (0, 1), (7, 8, 9, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_moe_bf16_error_spread_over_prompts_and_seeds(name):
    """An MoE family's free-running bf16 error at chip_smoke.py's cut over
    several weights and prompts, in both packages: a bf16 routing flip moves
    which tokens the token-major capacity drops, so each reading is a draw.
    Prints every draw and the largest reading of each kind as JSON lines
    (run with -s).  At every draw the arithmetic holds, and every
    free-running reading that chip_smoke.py gates (all but those of
    BF16_FREE_RUN_UNGATED) stays within ENGINE_REL_TOL."""
    import json

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py's weights come from a cuda Generator)")
    draws = []
    for seed in SPREAD_SEEDS:
        for p, r in zip(SPREAD_PROMPTS, _bf16_readings(name, seed, SPREAD_PROMPTS)):
            print(json.dumps({"bf16_spread": name, "seed": seed, "prompt_seed": p,
                              "readings": r}))
            draws.append(r)
    for label in draws[0]:
        largest = {key: max(r[label][key] for r in draws) for key in draws[0][label]}
        print(json.dumps({"bf16_spread_largest": name, "draws": len(draws), "logits": label,
                          **largest}))
    ungated = smoke.BF16_FREE_RUN_UNGATED.get(name, ())
    for r in draws:
        _assert_arithmetic(r)
        for label, x in r.items():
            if label not in ungated:
                assert x["port_card_bf16_vs_cpu_f32"] <= smoke.ENGINE_REL_TOL, (label, x)
