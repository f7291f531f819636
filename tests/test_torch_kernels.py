"""Port kernels vs the reference: the port's plain versions against
``repro.kernels.ref`` and the Pallas kernels (interpret mode) on the same
numpy inputs, at the sweeps and tolerances of tests/test_kernels.py; the
CUDA kernels against the plain versions on the card (``gpu`` marker).

The reference package is imported inside the CPU tests only, so the ``gpu``
tests also run where JAX is not installed:
    python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref as tref

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax():
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas

    return jnp, jref, flash_attention_pallas, decode_attention_pallas


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, dtype_name, *shapes):
    """The same numpy draws, cast to the dtype by each framework (both round
    to nearest even, so the bf16 values are identical)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [torch.from_numpy(a).to(TORCH_DTYPES[dtype_name]) for a in arrs], arrs


def _jax_inputs(arrs, dtype_name):
    jnp = _jax()[0]
    return [jnp.asarray(a).astype(getattr(jnp, dtype_name)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions vs the reference oracle and the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,bq,bk",
    [
        (1, 128, 4, 4, 64, 64, 64),  # MHA
        (2, 256, 8, 2, 64, 128, 64),  # GQA 4:1
        (1, 256, 6, 1, 32, 64, 128),  # MQA, uneven blocks
        (2, 128, 4, 2, 80, 128, 128),  # non-128 head dim
    ],
)
def test_attention_ref_sweep(dtype, b, s, hq, hkv, d, bq, bk):
    (tq, tk, tv), arrs = _inputs(0, dtype, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, dtype)
    got = tref.attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (b, s, hq, d)
    want = jref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pallas = flash_attention_pallas(q, k, v, causal=True, block_q=bq, block_k=bk,
                                    interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("window", [32, 100, 256])
def test_attention_ref_sliding_window(window):
    b, s, hq, hkv, d = 2, 256, 4, 2, 64
    (tq, tk, tv), arrs = _inputs(1, "float32", (b, s, hq, d), (b, s, hkv, d),
                                 (b, s, hkv, d))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, "float32")
    got = tref.attention_ref(tq, tk, tv, causal=True, sliding_window=window)
    want = jref.attention_ref(q, k, v, causal=True, sliding_window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    pallas = flash_attention_pallas(q, k, v, causal=True, sliding_window=window,
                                    block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=2e-5)


def test_attention_ref_noncausal():
    b, s, h, d = 1, 128, 4, 64
    (tq, tk, tv), arrs = _inputs(2, "float32", (b, s, h, d), (b, s, h, d), (b, s, h, d))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, "float32")
    got = tref.attention_ref(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(jref.attention_ref(q, k, v, causal=False)),
                               atol=2e-5, rtol=2e-5)
    pallas = flash_attention_pallas(q, k, v, causal=False, block_q=64, block_k=64,
                                    interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize(
    "sq,sk,causal,window,dv",
    [
        (300, 300, True, None, 64),  # odd S (a forward without a cache)
        (37, 37, True, 16, 64),  # odd S with a window
        (100, 300, True, None, 64),  # Sq < Sk: end-aligned causal mask
        (77, 150, False, None, 96),  # cross-attention shape, Dv != D
        (150, 77, False, None, 64),  # Sq > Sk, non-causal
    ],
)
def test_attention_ref_ragged_shapes(sq, sk, causal, window, dv):
    """Shapes the Pallas kernel does not take (it needs S % block == 0 and
    Sq == Sk): held against the reference oracle only."""
    b, hq, hkv, d = 2, 6, 2, 64
    (tq, tk, tv), arrs = _inputs(3, "float32", (b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, dv))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, "float32")
    got = tref.attention_ref(tq, tk, tv, causal=causal, sliding_window=window)
    want = jref.attention_ref(q, k, v, causal=causal, sliding_window=window)
    assert got.shape == (b, sq, hq, dv)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,smax,hq,hkv,d,length,bk",
    [
        (2, 256, 8, 2, 64, 137, 64),
        (1, 512, 4, 4, 64, 512, 128),  # full cache
        (3, 128, 4, 1, 32, 1, 64),  # single valid slot
        (2, 256, 16, 2, 64, 200, 256),  # big GQA group, one block
        (2, 192, 9, 3, 64, 100, 64),  # smollm's G = 3 (not a power of two)
    ],
)
def test_decode_attention_ref_sweep(dtype, b, smax, hq, hkv, d, length, bk):
    (tq, tk, tv), arrs = _inputs(4, dtype, (b, 1, hq, d), (b, smax, hkv, d),
                                 (b, smax, hkv, d))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, dtype)
    got = tref.decode_attention_ref(tq, tk, tv, length=length)
    want = jref.decode_attention_ref(q, k, v, length=jnp.int32(length))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pallas = decode_attention_pallas(q, k, v, length=jnp.int32(length), block_k=bk,
                                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("lens", [[1, 64, 137, 256], [300, 1, 256, 1000]])
def test_decode_attention_ref_ragged(lens):
    """Per-slot lengths, including lengths past Smax (idle engine slots keep
    counting), which clamp to Smax."""
    b, smax, hq, hkv, d = 4, 256, 8, 2, 64
    (tq, tk, tv), arrs = _inputs(5, "float32", (b, 1, hq, d), (b, smax, hkv, d),
                                 (b, smax, hkv, d))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, "float32")
    got = tref.decode_attention_ref(tq, tk, tv, length=torch.tensor(lens, dtype=torch.int32))
    jl = jnp.asarray(lens, jnp.int32)
    np.testing.assert_allclose(_np(got), _np(jref.decode_attention_ref(q, k, v, length=jl)),
                               atol=2e-5, rtol=2e-5)
    pallas = decode_attention_pallas(q, k, v, length=jl, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=2e-5)


def test_decode_attention_ref_empty_slot_is_zero_as_pallas():
    """A slot with no valid cache row (length 0, or below) gets zeros, as the
    Pallas kernel (and the CUDA kernel) give it; the other slots are as the
    reference oracle computes them."""
    lens = [0, 64, -3, 300]
    b, smax, hq, hkv, d = 4, 256, 8, 2, 64
    (tq, tk, tv), arrs = _inputs(10, "float32", (b, 1, hq, d), (b, smax, hkv, d),
                                 (b, smax, hkv, d))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, "float32")
    got = tref.decode_attention_ref(tq, tk, tv, length=torch.tensor(lens, dtype=torch.int32))
    jl = jnp.asarray(lens, jnp.int32)
    pallas = decode_attention_pallas(q, k, v, length=jl, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=2e-5)
    assert not got[0].any() and not got[2].any()
    want = _np(jref.decode_attention_ref(q, k, v, length=jl))
    np.testing.assert_allclose(_np(got)[[1, 3]], want[[1, 3]], atol=2e-5, rtol=2e-5)


def test_decode_attention_length_above_smax_is_full_cache():
    b, smax, hq, hkv, d = 2, 128, 6, 2, 32
    (tq, tk, tv), _ = _inputs(6, "float32", (b, 1, hq, d), (b, smax, hkv, d), (b, smax, hkv, d))
    over = tref.decode_attention_ref(tq, tk, tv, length=smax + 57)
    full = tref.decode_attention_ref(tq, tk, tv, length=smax)
    assert torch.equal(over, full)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [1, 7, 64, 100, 256])
def test_decode_split_ref_matches_decode_ref_and_pallas(dtype, split):
    """The split-K decode, done plainly (per-split partials, then their
    combine), against the one-pass plain version and the Pallas kernel, at
    lengths 0, 1, split - 1, split, split + 1, Smax and past Smax in one
    batch."""
    b, smax, hq, hkv, d = 7, 256, 6, 2, 64
    lens = [0, 1, max(split - 1, 0), split, split + 1, smax, smax + 9]
    (tq, tk, tv), arrs = _inputs(11, dtype, (b, 1, hq, d), (b, smax, hkv, d), (b, smax, hkv, d))
    length = torch.tensor(lens, dtype=torch.int32)
    m, l, acc = tref.decode_split_partials_ref(tq, tk, tv, length, split)
    n_splits = -(-smax // split)
    assert m.shape == l.shape == (b, hq, n_splits) and acc.shape == (b, hq, n_splits, d)
    got = tref.decode_split_combine_ref(m, l, acc, tq.dtype)
    assert got.dtype == tq.dtype and got.shape == (b, 1, hq, d)
    np.testing.assert_allclose(_np(got), _np(tref.decode_attention_ref(tq, tk, tv, length)),
                               **_tol(dtype))
    jnp, jref, flash_attention_pallas, decode_attention_pallas = _jax()
    q, k, v = _jax_inputs(arrs, dtype)
    pallas = decode_attention_pallas(q, k, v, length=jnp.asarray(lens, jnp.int32), block_k=64,
                                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("split", [1, 64, 100])
def test_decode_split_partials_empty_past_the_length(split):
    """A piece that starts at or past the (clamped) length is empty: m = -inf,
    l = 0, acc = 0, and it weighs nothing in the combine."""
    b, smax, hq, hkv, d = 4, 256, 4, 2, 32
    lens = [0, split, 200, 1000]
    (tq, tk, tv), _ = _inputs(12, "float32", (b, 1, hq, d), (b, smax, hkv, d), (b, smax, hkv, d))
    m, l, acc = tref.decode_split_partials_ref(tq, tk, tv, torch.tensor(lens), split)
    for i, n in enumerate(lens):
        live = -(-min(n, smax) // split)
        assert torch.isinf(m[i, :, live:]).all() and (m[i, :, live:] < 0).all()
        assert not l[i, :, live:].any() and not acc[i, :, live:].any()
        assert torch.isfinite(m[i, :, :live]).all() and (l[i, :, :live] >= 1).all()
    out = tref.decode_split_combine_ref(m, l, acc, tq.dtype)
    assert not out[0].any()


@pytest.mark.parametrize(
    "dtype,d,dv,body",
    [
        ("bfloat16", 64, 64, "tc"),  # smollm-135m, zamba2-1.2b
        ("bfloat16", 32, 32, "tc"),
        ("bfloat16", 80, 80, "tc"),
        ("bfloat16", 128, 256, "tc"),
        ("bfloat16", 40, 40, "simt"),  # not a multiple of 16
        ("bfloat16", 64, 72, "simt"),
        ("float32", 64, 64, "simt"),  # f32 keeps 2e-5 only on the CUDA cores
    ],
)
def test_flash_body_routing_by_shape(dtype, d, dv, body):
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), _ = _inputs(13, dtype, (1, 4, 2, d), (1, 4, 2, d), (1, 4, 2, dv))
    assert fa.body(q, k, v) == body


def test_flash_body_routing_misaligned_view_takes_cuda_cores():
    from repro_torch.kernels import flash_attention as fa

    (q,), _ = _inputs(14, "bfloat16", (1, 4 * 64 * 2 + 1))
    view = q[0, 1:].view(1, 4, 2, 64)  # 2 bytes past an aligned start
    assert view.data_ptr() % 16 == 2
    assert fa.body(view, view, view) == "simt"


def test_build_hashes_included_headers(tmp_path, monkeypatch):
    """A library's name changes with the source and with every csrc/ header
    it includes (transitively), so an edited header is rebuilt."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources(tmp_path / "k.cu")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build._lib_path("k")
    assert first == _build._lib_path("k") and first.name.startswith("libk-")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert _build._lib_path("k") not in (first, second)


def test_ops_on_cpu_dispatch_to_plain_versions_without_launches():
    ops.reset_launch_counts()
    (tq, tk, tv), _ = _inputs(7, "float32", (1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=True),
                       tref.attention_ref(tq, tk, tv, causal=True))
    assert torch.equal(ops.cross_attention(tq, tk, tv),
                       tref.attention_ref(tq, tk, tv, causal=False))
    q1 = tq[:, :1].contiguous()
    assert torch.equal(ops.decode_attention(q1, tk, tv, length=10),
                       tref.decode_attention_ref(q1, tk, tv, length=10))
    assert ops.launch_counts() == {}


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,dv,causal,window",
    [
        (1, 512, 512, 9, 3, 64, 64, True, None),  # smollm-135m prefill
        (1, 300, 300, 32, 32, 64, 64, True, None),  # zamba2-1.2b shared attention
        (1, 300, 300, 9, 3, 64, 64, True, None),  # odd S
        (2, 100, 300, 8, 2, 64, 64, True, None),  # Sq < Sk
        (1, 256, 256, 6, 1, 32, 32, True, None),  # MQA
        (2, 128, 128, 4, 2, 80, 80, True, 64),  # window, non-128 head dim
        (1, 77, 150, 4, 4, 128, 256, False, None),  # Dv != D, non-causal
    ],
)
def test_flash_attention_cuda_matches_plain(cuda, dtype, b, sq, sk, hq, hkv, d, dv, causal,
                                            window):
    (q, k, v), _ = _inputs(8, dtype, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv))
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    before = ops.launch_counts().get("flash_attention", 0)
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = tref.attention_ref(q, k, v, causal=causal, sliding_window=window)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,smax,hq,hkv,d,lens",
    [
        (8, 2048, 9, 3, 64, [1, 2048, 3000, 5, 700, 64, 65, 128]),  # smollm-135m
        (8, 2048, 32, 32, 64, [0, 2048, 2049, 1, 700, 64, 65, 33]),  # zamba2-1.2b, G = 1
        (2, 256, 8, 2, 64, [137, 137]),
        (3, 128, 4, 1, 32, [1, 1, 1]),
        (2, 256, 16, 2, 64, [200, 256]),
    ],
)
def test_decode_attention_cuda_matches_plain(cuda, dtype, b, smax, hq, hkv, d, lens):
    (q, k, v), _ = _inputs(9, dtype, (b, 1, hq, d), (b, smax, hkv, d), (b, smax, hkv, d))
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.launch_counts().get("decode_attention", 0)
    got = ops.decode_attention(q, k, v, length=length)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    want = tref.decode_attention_ref(q, k, v, length=length)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,dv,causal,window",
    [
        (2, 300, 300, 8, 2, 32, 32, True, None),  # head dims of the tensor-core body
        (2, 300, 300, 8, 2, 80, 80, True, None),
        (2, 300, 300, 8, 2, 128, 128, True, None),
        (2, 300, 300, 8, 2, 256, 256, True, None),
        (1, 77, 150, 4, 4, 128, 256, False, None),
        (2, 100, 300, 4, 2, 128, 256, True, None),
        (2, 100, 300, 8, 2, 64, 64, True, None),  # Sq < Sk
        (2, 1, 300, 9, 3, 64, 64, True, None),
        (2, 256, 256, 4, 2, 64, 64, True, 32),  # windows
        (2, 256, 256, 4, 2, 64, 64, True, 100),
        (2, 300, 300, 9, 3, 64, 64, True, 100),
        (2, 150, 77, 6, 2, 64, 64, False, None),
        (2, 1, 1, 9, 3, 64, 64, True, None),  # ragged S
        (2, 15, 15, 9, 3, 64, 64, True, None),
        (2, 17, 17, 9, 3, 64, 64, True, None),
        (2, 1023, 1023, 9, 3, 64, 64, True, None),
        (1, 128, 128, 4, 2, 40, 40, True, None),  # the CUDA-core body in bf16
    ],
)
def test_flash_attention_cuda_bf16_bodies(cuda, b, sq, sk, hq, hkv, d, dv, causal, window):
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), _ = _inputs(15, "bfloat16", (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv))
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    body = "tc" if d % 16 == 0 and dv % 16 == 0 else "simt"
    assert fa.body(q, k, v) == body
    before = ops.launch_counts().get(f"flash_attention.{body}", 0)
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()[f"flash_attention.{body}"] == before + 1
    want = tref.attention_ref(q, k, v, causal=causal, sliding_window=window)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol("bfloat16"))


def _chip_smoke():
    """chip_smoke.py at the repository's root, whose phase 3 checks of phase
    10's kernel shapes the test below runs."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
def test_family_shapes_hold_to_f32_plain(cuda, arch):
    """Flash and the bf16 decode at the shapes the family's engine gives them
    (Mixtral's window at S 4096 and 8192 and decode over a wrapped ring of
    4096 rows, DeepSeek's MLA prefill at D 192 / Dv 128, Seamless's encoder
    and cross-attention at Sq 1 and 256), held to the plain version in f32
    by chip_smoke.py's row-scaled check, each with a planted control that
    must fail it."""
    from repro_torch.kernels import decode_attention as dec, flash_attention as fa

    smoke = _chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(17)

    def rn(shape, dt):
        return torch.randn(shape, generator=gen, device=cuda).to(dt)

    smoke.check_family_shapes(torch, ops, tref, fa, dec, rn, archs=[arch])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [16, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(9, 3), (32, 32), (16, 2)])
def test_decode_attention_cuda_split_edges(cuda, monkeypatch, dtype, split, hq, hkv):
    """Lengths 0, 1, split - 1, split, split + 1, Smax and past Smax in one
    batch, at several splits, against the plain version and the plain
    split-K decode."""
    from repro_torch.kernels import decode_attention as dec

    monkeypatch.setattr(dec, "SPLIT", split)
    b, smax, d = 8, 2048, 64
    lens = [0, 1, split - 1, split, split + 1, smax, smax + 952, 700]
    (q, k, v), _ = _inputs(16, dtype, (b, 1, hq, d), (b, smax, hkv, d), (b, smax, hkv, d))
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = dec.decode_attention_cuda(q, k, v, length)
    torch.cuda.synchronize()
    assert not got[0].float().any()
    want = tref.decode_attention_ref(q, k, v, length)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol(dtype))
    split_ref = tref.decode_split_combine_ref(
        *tref.decode_split_partials_ref(q, k, v, length, split), q.dtype)
    np.testing.assert_allclose(_np(got.cpu()), _np(split_ref.cpu()), **_tol(dtype))


# ---------------------------------------------------------------------------
# the kernels under autograd, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", ["smollm-135m", "zamba2-1.2b shared attention",
                                   "windowed (Mixtral heads)", "MLA (DeepSeek-V3)", "ssd_scan"])
def test_autograd_functions_match_plain_autograd(cuda, label, dtype):
    """ops.flash_attention and ops.ssd_scan with inputs that require grad:
    the hand-written forward (counted once under the body the shape
    selects) inside its autograd Function, output and every gradient held
    to the plain version's autograd in f32 at chip_smoke.py phase 11's
    shapes and limits (f32: 1e-4 of the largest magnitude; bf16: the
    row-scaled FAMILY_ROW_TOL), the windowed f32 case with its planted
    control (a window one row short must fail)."""
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ssd

    smoke = _chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(19)
    dt = TORCH_DTYPES[dtype]
    if label == "ssd_scan":
        smoke.autograd_ssd_case(torch, ops, tref, ssd, gen, dt, smoke.TRAIN_SSD_CASE)
    else:
        smoke.autograd_flash_case(torch, ops, tref, fa, gen, label, dt,
                                  smoke.TRAIN_FLASH_CASES[label])


@pytest.mark.gpu
def test_kernel_wrappers_raise_under_grad(cuda):
    """No kernel output silently cuts the graph: the decode wrappers (no
    training path, no backward) and the direct *_cuda calls of flash and
    the SSD scan raise under grad mode with an input that requires grad;
    under no_grad they launch."""
    from repro_torch.kernels import decode_attention as dec, decode_attention_q8 as q8
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ssd

    (q, k, v), _ = _inputs(21, "bfloat16", (2, 1, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    q, k, v = q.to(cuda).requires_grad_(), k.to(cuda), v.to(cuda)
    kq, ks = tref.quantize_kv(k)
    vq, vs = tref.quantize_kv(v)
    calls = {
        "decode_attention": lambda: ops.decode_attention(q, k, v, length=100),
        "decode_attention_cuda": lambda: dec.decode_attention_cuda(q, k, v, 100),
        "decode_attention_q8": lambda: ops.decode_attention_q8(q, kq, ks, vq, vs, length=100),
        "decode_attention_q8_cuda": lambda: q8.decode_attention_q8_cuda(q, kq, ks, vq, vs, 100),
        "flash_attention_cuda": lambda: fa.flash_attention_cuda(q, k[:, :1].contiguous(),
                                                                v[:, :1].contiguous(), False),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None
    x = torch.randn((1, 64, 2, 16), device=cuda, requires_grad=True)
    dt = torch.rand((1, 64, 2), device=cuda)
    A, B, C = -torch.ones(2, device=cuda), torch.randn((1, 64, 16), device=cuda), \
        torch.randn((1, 64, 16), device=cuda)
    with pytest.raises(RuntimeError, match="has no backward"):
        ssd.ssd_scan_cuda(x, dt, A, B, C)
    assert ops.ssd_scan(x, dt, A, B, C)[0].grad_fn is not None
