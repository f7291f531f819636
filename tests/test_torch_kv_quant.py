"""Port int8 KV cache vs the reference: ``quantize_kv`` bit for bit,
``decode_attention_q8_ref`` against the reference oracle and
``decode_attention_q8_pallas`` (interpret mode) at the sweeps of
tests/test_kernels.py, reduced smollm-135m logits and engine with
``set_kv_quant(True)`` on both sides; the CUDA kernel against the plain
version on the card (``gpu`` marker).

The reference package is imported inside the CPU tests only, so the ``gpu``
tests also run where JAX is not installed:
    python -m pytest -q -m gpu tests/test_torch_kv_quant.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref as tref

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's q8 sweep tolerance (f32); bf16 as for the other kernels
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _qkv(seed, b, smax, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, 1, hq, d), (b, smax, hkv, d), (b, smax, hkv, d))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


@contextlib.contextmanager
def _kv_quant():
    """int8 KV caches on both sides, reset even when the test fails."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    jlayers.set_kv_quant(True)
    tlayers.set_kv_quant(True)
    try:
        yield
    finally:
        jlayers.set_kv_quant(False)
        tlayers.set_kv_quant(False)


# ---------------------------------------------------------------------------
# quantize_kv and the plain q8 decode vs the reference and the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_equal_to_reference(dtype):
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 37, 3, 64)).astype(np.float32) * 3
    k[0, 0, 0] = 0.0  # all-zero row: the 1e-8 floor of the scale
    k[1, 2, 1, :4] = [127.0, -127.0, 63.5, -0.5]  # ties round half to even
    tk = torch.from_numpy(k).to(TORCH_DTYPES[dtype])
    q, s = tref.quantize_kv(tk)
    jq, js = jref.quantize_kv(jnp.asarray(k).astype(getattr(jnp, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize(
    "b,smax,hq,hkv,d,length,bk",
    [
        (2, 256, 8, 2, 64, 137, 64),
        (1, 512, 4, 4, 64, 512, 128),
        (2, 256, 16, 2, 64, 200, 256),
        (2, 192, 9, 3, 64, 100, 64),  # smollm's G = 3
    ],
)
def test_decode_attention_q8_ref_sweep(b, smax, hq, hkv, d, length, bk):
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention_q8_pallas

    q, k, v = _qkv(8, b, smax, hq, hkv, d)
    tk, tks = tref.quantize_kv(torch.from_numpy(k))
    tv, tvs = tref.quantize_kv(torch.from_numpy(v))
    got = tref.decode_attention_q8_ref(torch.from_numpy(q), tk, tks, tv, tvs, length=length)
    jargs = [jnp.asarray(a.numpy()) for a in (tk, tks, tv, tvs)]
    ln = jnp.int32(length)
    want = jref.decode_attention_q8_ref(jnp.asarray(q), *jargs, length=ln)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    pallas = decode_attention_q8_pallas(jnp.asarray(q), *jargs, length=ln, block_k=bk,
                                        interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL["float32"])
    # quantization error against full-precision attention stays small
    fp = tref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), length=length)
    assert float((got - fp).abs().max()) < 0.05


@pytest.mark.parametrize("lens", [[7, 256, 100], [1, 300, 256]])
def test_decode_attention_q8_ref_ragged(lens):
    """Per-slot lengths, including one past Smax (clamped to Smax)."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention_q8_pallas

    q, k, v = _qkv(9, 3, 256, 8, 2, 64)
    tk, tks = tref.quantize_kv(torch.from_numpy(k))
    tv, tvs = tref.quantize_kv(torch.from_numpy(v))
    got = tref.decode_attention_q8_ref(torch.from_numpy(q), tk, tks, tv, tvs,
                                       length=torch.tensor(lens, dtype=torch.int32))
    jargs = [jnp.asarray(a.numpy()) for a in (tk, tks, tv, tvs)]
    jl = jnp.asarray(lens, jnp.int32)
    np.testing.assert_allclose(
        _np(got), _np(jref.decode_attention_q8_ref(jnp.asarray(q), *jargs, length=jl)),
        **TOL["float32"])
    pallas = decode_attention_q8_pallas(jnp.asarray(q), *jargs, length=jl, block_k=64,
                                        interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [1, 7, 64, 100])
def test_decode_q8_split_ref_matches_q8_ref_and_pallas(dtype, split):
    """The split-K int8 decode, done plainly with the scales folded in as the
    kernel folds them (per-split partials, then the bf16 decode's combine),
    against the one-pass plain version and the Pallas kernel, at lengths 0,
    1, split - 1, split, split + 1, Smax and past Smax in one batch."""
    import jax.numpy as jnp

    from repro.kernels.decode_attention import decode_attention_q8_pallas

    b, smax, hq, hkv, d = 7, 256, 6, 2, 64
    lens = [0, 1, max(split - 1, 0), split, split + 1, smax, smax + 9]
    q, k, v = _qkv(12, b, smax, hq, hkv, d)
    tq = torch.from_numpy(q).to(TORCH_DTYPES[dtype])
    tk, tks = tref.quantize_kv(torch.from_numpy(k))
    tv, tvs = tref.quantize_kv(torch.from_numpy(v))
    length = torch.tensor(lens, dtype=torch.int32)
    m, l, acc = tref.decode_q8_split_partials_ref(tq, tk, tks, tv, tvs, length, split)
    n_splits = -(-smax // split)
    assert m.shape == l.shape == (b, hq, n_splits) and acc.shape == (b, hq, n_splits, d)
    got = tref.decode_split_combine_ref(m, l, acc, tq.dtype)
    assert got.dtype == tq.dtype and got.shape == (b, 1, hq, d)
    assert not got[0].float().any()  # length 0: zeros
    np.testing.assert_allclose(
        _np(got), _np(tref.decode_attention_q8_ref(tq, tk, tks, tv, tvs, length)), **TOL[dtype])
    jargs = [jnp.asarray(a.numpy()) for a in (tk, tks, tv, tvs)]
    pallas = decode_attention_q8_pallas(jnp.asarray(q).astype(getattr(jnp, dtype)), *jargs,
                                        length=jnp.asarray(lens, jnp.int32), block_k=64,
                                        interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("split", [1, 64, 100])
def test_decode_q8_split_partials_empty_past_the_length(split):
    """A piece that starts at or past the (clamped) length is empty: m = -inf,
    l = 0, acc = 0; a live piece's l counts its rows' unscaled
    probabilities (>= 1, its largest is exp(0))."""
    b, smax, hq, hkv, d = 4, 256, 4, 2, 32
    lens = [0, split, 200, 1000]
    q, k, v = _qkv(13, b, smax, hq, hkv, d)
    tk, tks = tref.quantize_kv(torch.from_numpy(k))
    tv, tvs = tref.quantize_kv(torch.from_numpy(v))
    m, l, acc = tref.decode_q8_split_partials_ref(torch.from_numpy(q), tk, tks, tv, tvs,
                                                  torch.tensor(lens), split)
    for i, n in enumerate(lens):
        live = -(-min(n, smax) // split)
        assert torch.isinf(m[i, :, live:]).all() and (m[i, :, live:] < 0).all()
        assert not l[i, :, live:].any() and not acc[i, :, live:].any()
        assert torch.isfinite(m[i, :, :live]).all() and (l[i, :, :live] >= 1).all()


def test_decode_attention_q8_ops_on_cpu_is_the_plain_version():
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 2, 64, 4, 2, 32))
    kq, ks = tref.quantize_kv(k)
    vq, vs = tref.quantize_kv(v)
    assert torch.equal(ops.decode_attention_q8(q, kq, ks, vq, vs, length=10),
                       tref.decode_attention_q8_ref(q, kq, ks, vq, vs, length=10))
    assert ops.launch_counts() == {}


# ---------------------------------------------------------------------------
# reduced smollm-135m with an int8 cache: logits and engine vs the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smollm():
    import jax

    from repro.configs import get_config, reduced
    from repro.models import bundle as jbundle
    from repro_torch.bridge import params_to_torch
    from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
    from repro_torch.models import bundle as tbundle

    jmb = jbundle(reduced(get_config("smollm-135m"), capacity_factor=8.0))
    jparams = jmb.init(jax.random.key(0))
    tmb = tbundle(t_reduced(t_get_config("smollm-135m")))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg, device="cpu")
    return jmb, jparams, tmb, tparams


def test_int8_cache_layout_matches_reference(smollm):
    jmb, _, tmb, _ = smollm
    with _kv_quant():
        jc = jmb.model.init_cache(3, 32, ragged=True)
        tc = tmb.model.init_cache(3, 32, ragged=True, device="cpu")
    ja, ta = jc["groups"][0]["attn"], tc["groups"][0]["attn"]
    assert set(ta) == set(ja) == {"k", "v", "k_s", "v_s", "index"}
    for name in ja:
        assert tuple(ta[name].shape) == ja[name].shape
        assert str(ta[name].dtype).split(".")[-1] == str(ja[name].dtype)
    # the switch is read when a cache is built: off again, a bf16/f32 cache
    assert "k_s" not in tmb.model.init_cache(1, 8, device="cpu")["groups"][0]["attn"]


def _assert_int8_cache_close(t, j):
    """K/V come out of f32 GEMMs summed in another order (~1e-7 relative), so
    a scale may differ in its last bit and a value sitting on a rounding
    boundary by one int8 step."""
    for name in ("k_s", "v_s"):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]), rtol=1e-5, atol=0)
    for name in ("k", "v"):
        diff = np.abs(t[name].numpy().astype(np.int32) - np.asarray(j[name]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_int8_prefill_and_ragged_decode_logits_match_reference(smollm):
    import jax.numpy as jnp

    from repro.serving.kvcache import insert_prefix as j_insert_prefix
    from repro_torch.serving.kvcache import insert_prefix

    jmb, jparams, tmb, tparams = smollm
    tol = dict(atol=1e-4, rtol=1e-4)
    B, P, max_len = 3, 6, 32
    toks = np.random.default_rng(2).integers(1, 255, size=(B, P))
    with _kv_quant():
        lj, cj = jmb.prefill_fn(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                                max_len=max_len)
        lt, ct = tmb.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
        _assert_int8_cache_close(ct["groups"][0]["attn"], cj["groups"][0]["attn"])
        # uniform decode step
        nxt = np.random.default_rng(3).integers(1, 255, size=(B, 1))
        dj, _ = jmb.decode_fn(jparams, cj, jnp.asarray(nxt, jnp.int32), jnp.int32(P))
        dt, _ = tmb.decode_fn(tparams, ct, torch.from_numpy(nxt), torch.tensor(P))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **tol)
        # ragged decode step over prompts of different true lengths
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
        pos = np.asarray(lens, np.int32)
        rj, cache_j, _ = jmb.model.forward(jparams, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                           cache=cache_j, positions=jnp.asarray(pos)[:, None])
        rt, cache_t, _ = tmb.model.forward(tparams, {"tokens": torch.from_numpy(nxt)},
                                        cache=cache_t, positions=torch.from_numpy(pos)[:, None])
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **tol)
    _assert_int8_cache_close(cache_t["groups"][0]["attn"], cache_j["groups"][0]["attn"])
    np.testing.assert_array_equal(cache_t["groups"][0]["attn"]["index"].numpy(),
                                  np.asarray(cache_j["groups"][0]["attn"]["index"]))


def test_int8_engine_matches_reference_engine(smollm):
    from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
    from repro.serving import Request as JRequest
    from repro_torch.serving import Engine, EngineConfig, Request

    jmb, jparams, tmb, tparams = smollm
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 255, size=n))) for n in (5, 3, 7, 4, 9)]
    with _kv_quant():
        jeng = JEngine(jmb, jparams, JEngineConfig(max_slots=3, max_len=64))
        teng = Engine(tmb, tparams, EngineConfig(max_slots=3, max_len=64))
        assert teng.cache["groups"][0]["attn"]["k"].dtype == torch.int8
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(rid=f"r{i}", prompt=p, max_new_tokens=6))
            teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6))
        want = {c.rid: (c.tokens, c.finish_reason) for c in jeng.run()}
        got = {c.rid: (c.tokens, c.finish_reason) for c in teng.run()}
    assert got == want
    assert teng.stats == jeng.stats


# ---------------------------------------------------------------------------
# the CUDA kernel vs its plain version, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,smax,hq,hkv,d,lens",
    [
        (8, 2048, 9, 3, 64, [1, 2048, 3000, 5, 700, 64, 65, 128]),  # smollm-135m
        (2, 256, 8, 2, 64, [137, 137]),
        (1, 512, 4, 4, 64, [512]),
        (2, 256, 16, 2, 64, [200, 256]),
        (3, 256, 8, 2, 64, [7, 256, 100]),
    ],
)
def test_decode_attention_q8_cuda_matches_plain(cuda, dtype, b, smax, hq, hkv, d, lens):
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, b, smax, hq, hkv, d))
    q = q.to(TORCH_DTYPES[dtype]).to(cuda)
    kq, ks = (t.to(cuda) for t in tref.quantize_kv(k))
    vq, vs = (t.to(cuda) for t in tref.quantize_kv(v))
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.launch_counts().get("decode_attention_q8", 0)
    got = ops.decode_attention_q8(q, kq, ks, vq, vs, length=length)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention_q8"] == before + 1
    want = tref.decode_attention_q8_ref(q, kq, ks, vq, vs, length=length)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [16, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(9, 3), (32, 32), (16, 2)])
def test_decode_attention_q8_cuda_split_edges(cuda, monkeypatch, dtype, split, hq, hkv):
    """Lengths 0, 1, split - 1, split, split + 1, Smax and past Smax in one
    batch, at several splits, against the plain version and the plain
    split-K int8 decode; one call is one launch."""
    from repro_torch.kernels import decode_attention_q8 as q8

    monkeypatch.setattr(q8, "SPLIT", split)
    b, smax, d = 8, 2048, 64
    lens = [0, 1, split - 1, split, split + 1, smax, smax + 952, 700]
    q, k, v = (torch.from_numpy(a) for a in _qkv(14, b, smax, hq, hkv, d))
    q = q.to(TORCH_DTYPES[dtype]).to(cuda)
    kq, ks = (t.to(cuda) for t in tref.quantize_kv(k))
    vq, vs = (t.to(cuda) for t in tref.quantize_kv(v))
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.launch_counts().get("decode_attention_q8", 0)
    got = q8.decode_attention_q8_cuda(q, kq, ks, vq, vs, length)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention_q8"] == before + 1
    assert not got[0].float().any()
    want = tref.decode_attention_q8_ref(q, kq, ks, vq, vs, length)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    split_ref = tref.decode_split_combine_ref(
        *tref.decode_q8_split_partials_ref(q, kq, ks, vq, vs, length, split), q.dtype)
    np.testing.assert_allclose(_np(got.cpu()), _np(split_ref.cpu()), **TOL[dtype])


@pytest.mark.gpu
def test_decode_attention_q8_cuda_scalar_length_and_odd_head_dim(cuda):
    """A scalar length is broadcast; D = Dv = 40 takes the element-wise loads."""
    for d, length in ((64, 300), (40, 77)):
        q, k, v = (torch.from_numpy(a) for a in _qkv(15, 2, 512, 9, 3, d))
        q = q.to(torch.bfloat16).to(cuda)
        kq, ks = (t.to(cuda) for t in tref.quantize_kv(k))
        vq, vs = (t.to(cuda) for t in tref.quantize_kv(v))
        got = ops.decode_attention_q8(q, kq, ks, vq, vs, length=length)
        torch.cuda.synchronize()
        want = tref.decode_attention_q8_ref(q, kq, ks, vq, vs, length=length)
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL["bfloat16"])
