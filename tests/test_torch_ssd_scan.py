"""Port SSD scan vs the reference: ``ref.ssd_scan_ref`` against
``repro.kernels.ref.ssd_scan_ref`` and ``ssd_scan_pallas`` (interpret mode)
on the same numpy inputs, at the sweep and tolerances of
tests/test_kernels.py; ``mamba2_block`` against the reference block; the
CUDA kernel against the plain version on the card (``gpu`` marker).

The reference package is imported inside the CPU tests only, so the ``gpu``
tests also run where JAX is not installed:
    python -m pytest -q -m gpu tests/test_torch_ssd_scan.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref as tref

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(name):
    # tests/test_kernels.py::test_ssd_scan_sweep's tolerances
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else dict(atol=5e-5, rtol=5e-4)


def _ssd_inputs(seed, b, s, h, p, n):
    """x, dt (softplus, f32), A (negative), B, C as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    return x, dt, A, Bm, Cm


def _torch(arrs, dtype_name):
    """x, B, C in the working dtype; dt and A stay f32."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    dt_ = TORCH_DTYPES[dtype_name]
    return x.to(dt_), dt, A, Bm.to(dt_), Cm.to(dt_)


def _jax(arrs, dtype_name):
    import jax.numpy as jnp

    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in arrs)
    dt_ = getattr(jnp, dtype_name)
    return x.astype(dt_), dt, A, Bm.astype(dt_), Cm.astype(dt_)


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
# plain version vs the reference oracle and the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,p,n,chunk",
    [
        (1, 128, 2, 16, 8, 32),
        (2, 256, 4, 32, 16, 64),
        (1, 64, 8, 8, 64, 64),  # single chunk
    ],
)
def test_ssd_scan_ref_sweep(dtype, b, s, h, p, n, chunk):
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan_pallas

    arrs = _ssd_inputs(0, b, s, h, p, n)
    y, hT = tref.ssd_scan_ref(*_torch(arrs, dtype))
    assert y.dtype == TORCH_DTYPES[dtype] and y.shape == (b, s, h, p)
    assert hT.dtype == torch.float32 and hT.shape == (b, h, p, n)
    jx = _jax(arrs, dtype)
    for want_y, want_h in (jref.ssd_scan_ref(*jx),
                           ssd_scan_pallas(*jx, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(_np(y), _np(want_y), **_tol(dtype))
        np.testing.assert_allclose(_np(hT), _np(want_h), **_tol(dtype))


@pytest.mark.parametrize("s", [100, 1, 33])
def test_ssd_scan_ref_ragged_length(s):
    """S not a multiple of any chunk (the Pallas kernel asserts there): held
    against the reference oracle only, with an initial state."""
    from repro.kernels import ref as jref

    import jax.numpy as jnp

    b, h, p, n = 2, 3, 16, 8
    arrs = _ssd_inputs(1, b, s, h, p, n)
    h0 = np.random.default_rng(2).standard_normal((b, h, p, n)).astype(np.float32)
    y, hT = tref.ssd_scan_ref(*_torch(arrs, "float32"), initial_state=torch.from_numpy(h0))
    want_y, want_h = jref.ssd_scan_ref(*_jax(arrs, "float32"), initial_state=jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol("float32"))
    np.testing.assert_allclose(_np(hT), _np(want_h), **_tol("float32"))


def test_ssd_scan_ref_initial_state_chain():
    """Two halves with the state carried == the whole sequence, and the
    second half equals the Pallas kernel given the same state."""
    from repro.kernels.ssd_scan import ssd_scan_pallas

    import jax.numpy as jnp

    b, s, h, p, n = 1, 128, 2, 8, 8
    x, dt, A, Bm, Cm = _torch(_ssd_inputs(3, b, s, h, p, n), "float32")
    y_full, h_full = tref.ssd_scan_ref(x, dt, A, Bm, Cm)
    half = s // 2
    y1, h1 = tref.ssd_scan_ref(x[:, :half], dt[:, :half], A, Bm[:, :half], Cm[:, :half])
    y2, h2 = tref.ssd_scan_ref(x[:, half:], dt[:, half:], A, Bm[:, half:], Cm[:, half:],
                               initial_state=h1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full), **_tol("float32"))
    np.testing.assert_allclose(_np(h2), _np(h_full), **_tol("float32"))
    jx = [jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)]
    py2, ph2 = ssd_scan_pallas(jx[0][:, half:], jx[1][:, half:], jx[2], jx[3][:, half:],
                               jx[4][:, half:], chunk=32, initial_state=jnp.asarray(h1.numpy()),
                               interpret=True)
    np.testing.assert_allclose(_np(y2), _np(py2), **_tol("float32"))
    np.testing.assert_allclose(_np(h2), _np(ph2), **_tol("float32"))


def _three_passes(x, dt, A, Bm, Cm, h0=None):
    """The tensor-core body's structure, plainly: chunk states, state
    passing, chunk scan."""
    states, cum_last = tref.ssd_chunk_states_ref(x, dt, A, Bm, chunk=64)
    h_enter, hT = tref.ssd_state_passing_ref(states, cum_last, h0)
    return tref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, h_enter, chunk=64), hT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize(
    "b,s,h,p,n",
    [
        (1, 128, 2, 16, 8),
        (2, 256, 4, 32, 16),
        (1, 64, 8, 8, 64),  # single chunk
    ],
)
def test_ssd_three_passes_match_ref_and_pallas(dtype, with_state, b, s, h, p, n):
    """The three passes composed == the sequential plain version and the
    Pallas kernel at its 64-step chunk (S % 64 == 0)."""
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import ssd_scan_pallas

    arrs = _ssd_inputs(10, b, s, h, p, n)
    h0 = (np.random.default_rng(11).standard_normal((b, h, p, n)).astype(np.float32)
          if with_state else None)
    th0 = torch.from_numpy(h0) if with_state else None
    tx = _torch(arrs, dtype)
    y, hT = _three_passes(*tx, th0)
    assert y.dtype == TORCH_DTYPES[dtype] and y.shape == (b, s, h, p)
    assert hT.dtype == torch.float32 and hT.shape == (b, h, p, n)
    wy, wh = tref.ssd_scan_ref(*tx, initial_state=th0)
    np.testing.assert_allclose(_np(y), _np(wy), **_tol(dtype))
    np.testing.assert_allclose(_np(hT), _np(wh), **_tol(dtype))
    py, ph = ssd_scan_pallas(*_jax(arrs, dtype), chunk=64,
                             initial_state=jnp.asarray(h0) if with_state else None,
                             interpret=True)
    np.testing.assert_allclose(_np(y), _np(py), **_tol(dtype))
    np.testing.assert_allclose(_np(hT), _np(ph), **_tol(dtype))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 33, 100])
def test_ssd_three_passes_ragged_length(with_state, s):
    """S not a multiple of the chunk: the last chunk is short (padded with
    dt = 0 in the plain passes); against the reference oracle."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    b, h, p, n = 2, 3, 16, 8
    arrs = _ssd_inputs(12, b, s, h, p, n)
    h0 = (np.random.default_rng(13).standard_normal((b, h, p, n)).astype(np.float32)
          if with_state else None)
    y, hT = _three_passes(*_torch(arrs, "float32"),
                          torch.from_numpy(h0) if with_state else None)
    want_y, want_h = jref.ssd_scan_ref(*_jax(arrs, "float32"),
                                       initial_state=jnp.asarray(h0) if with_state else None)
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol("float32"))
    np.testing.assert_allclose(_np(hT), _np(want_h), **_tol("float32"))


def test_ssd_state_passing_chunk_boundaries():
    """Pass 2 hands each chunk the state the sequential scan holds at the
    chunk's start: S = 0 gives the initial state back."""
    b, s, h, p, n = 1, 192, 2, 8, 8
    x, dt, A, Bm, Cm = _torch(_ssd_inputs(14, b, s, h, p, n), "float32")
    h0 = torch.from_numpy(np.random.default_rng(15).standard_normal((b, h, p, n))
                          .astype(np.float32))
    states, cum_last = tref.ssd_chunk_states_ref(x, dt, A, Bm)
    h_enter, hT = tref.ssd_state_passing_ref(states, cum_last, h0)
    assert h_enter.shape == (b, 3, h, p, n) and torch.equal(h_enter[:, 0], h0)
    for c in (1, 2):
        _, want = tref.ssd_scan_ref(x[:, :64 * c], dt[:, :64 * c], A, Bm[:, :64 * c],
                                    Cm[:, :64 * c], initial_state=h0)
        np.testing.assert_allclose(_np(h_enter[:, c]), _np(want), **_tol("float32"))
    empty, e_cum = tref.ssd_chunk_states_ref(x[:, :0], dt[:, :0], A, Bm[:, :0])
    assert empty.shape == (b, 0, h, p, n) and e_cum.shape == (b, 0, h)
    _, h_same = tref.ssd_state_passing_ref(empty, e_cum, h0)
    assert torch.equal(h_same, h0)


@pytest.mark.parametrize(
    "dtype,p,n,body",
    [
        ("bfloat16", 128, 64, "tc"),  # zamba2-1.2b
        ("bfloat16", 16, 16, "tc"),
        ("bfloat16", 256, 128, "tc"),
        ("bfloat16", 272, 64, "simt"),  # P above 256: a head's tiles do not fit
        ("bfloat16", 40, 16, "simt"),  # P not a multiple of 16
        ("bfloat16", 32, 8, "simt"),  # N not a multiple of 16
        ("float32", 128, 64, "simt"),  # f32 keeps 5e-5 only on the CUDA cores
    ],
)
def test_ssd_body_routing_by_shape(dtype, p, n, body):
    from repro_torch.kernels import ssd_scan as ssd

    x, _, _, Bm, Cm = _torch(_ssd_inputs(16, 1, 4, 2, p, n), dtype)
    assert ssd.body(x, Bm, Cm) == body


def test_ssd_body_routing_by_alignment():
    """mamba2_block's views of the convolution output (row stride
    d_inner + 2N, B and C at offsets d_inner and d_inner + N) keep the
    tensor cores; a view 2 bytes off a 16-byte boundary, or a sequence
    stride that is not a multiple of 8 elements, takes the CUDA cores."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, n = 1, 5, 4, 32, 16
    xbc = torch.zeros((b, s, h * p + 2 * n), dtype=torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    Bm, Cm = xbc[..., h * p: h * p + n], xbc[..., h * p + n:]
    assert not x.is_contiguous() and ssd.body(x, Bm, Cm) == "tc"
    off = torch.zeros((b * s * (h * p + 2 * n) + 1,), dtype=torch.bfloat16)[1:]
    off = off.view(b, s, h * p + 2 * n)
    assert off.data_ptr() % 16 == 2
    assert ssd.body(off[..., :h * p].reshape(b, s, h, p), Bm, Cm) == "simt"
    wide = torch.zeros((b, s, h * p + 2 * n + 4), dtype=torch.bfloat16)  # stride % 8 == 4
    assert ssd.body(wide[..., :h * p].reshape(b, s, h, p), Bm, Cm) == "simt"


def test_ssd_scan_ops_on_cpu_is_the_plain_version():
    ops.reset_launch_counts()
    x, dt, A, Bm, Cm = _torch(_ssd_inputs(4, 1, 40, 2, 8, 8), "float32")
    y, hT = ops.ssd_scan(x, dt, A, Bm, Cm)
    wy, wh = tref.ssd_scan_ref(x, dt, A, Bm, Cm)
    assert torch.equal(y, wy) and torch.equal(hT, wh)
    assert ops.launch_counts() == {}


# ---------------------------------------------------------------------------
# mamba2_block: prefill (SSD scan with the cache's state) + one decode step
# ---------------------------------------------------------------------------
def test_mamba2_block_prefill_and_decode_match_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.models import ssm as jssm
    from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
    from repro_torch.models import ssm as tssm

    cfg = reduced(get_config("zamba2-1.2b"))
    tcfg = t_reduced(t_get_config("zamba2-1.2b"))
    jp = jssm.init_mamba2(jax.random.key(0), cfg, jnp.float32)
    # a_log / dt_bias / d_skip are constants at init: give them values
    rng = np.random.default_rng(5)
    h = jp["a_log"].shape[0]
    jp = {**jp, "a_log": jnp.asarray(rng.standard_normal(h).astype(np.float32) * 0.3),
          "dt_bias": jnp.asarray(rng.standard_normal(h).astype(np.float32) * 0.5),
          "d_skip": jnp.asarray(rng.standard_normal(h).astype(np.float32))}
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    b, s = 2, 11
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)

    jstate = jssm.init_mamba_state(cfg, b, jnp.float32)
    jy, jstate = jssm.mamba2_block(jp, jnp.asarray(x), cfg, jstate)
    jy1, jstate = jssm.mamba2_block(jp, jnp.asarray(x1), cfg, jstate)

    tstate = tssm.init_mamba_state(tcfg, b, torch.float32, "cpu")
    ty, ret = tssm.mamba2_block(tp, torch.from_numpy(x), tcfg, tstate)
    assert ret is tstate  # advanced in place
    ty1, _ = tssm.mamba2_block(tp, torch.from_numpy(x1), tcfg, tstate)

    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), **tol)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), **tol)
    # no state: the full-sequence form
    jy0, _ = jssm.mamba2_block(jp, jnp.asarray(x), cfg, None)
    ty0, st0 = tssm.mamba2_block(tp, torch.from_numpy(x), tcfg, None)
    assert st0 is None
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **tol)


# ---------------------------------------------------------------------------
# the CUDA kernel vs its plain version, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,p,n,with_state",
    [
        (1, 700, 32, 128, 64, True),  # zamba2-1.2b prefill, ragged tail
        (1, 32, 32, 128, 64, False),  # one short chunk
        (1, 128, 2, 16, 8, False),  # the reference sweep
        (2, 256, 4, 32, 16, True),
        (1, 64, 8, 8, 64, False),
        (3, 100, 3, 40, 8, True),  # P not a multiple of the kernel's 32-row split
    ],
)
def test_ssd_scan_cuda_matches_plain(cuda, dtype, b, s, h, p, n, with_state):
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _torch(_ssd_inputs(6, b, s, h, p, n), dtype))
    h0 = (torch.from_numpy(np.random.default_rng(7).standard_normal((b, h, p, n))
                           .astype(np.float32)).to(cuda) if with_state else None)
    before = ops.launch_counts().get("ssd_scan", 0)
    y, hT = ops.ssd_scan(x, dt, A, Bm, Cm, initial_state=h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    wy, wh = tref.ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=h0)
    assert y.dtype == x.dtype and hT.dtype == torch.float32
    np.testing.assert_allclose(_np(y.cpu()), _np(wy.cpu()), **_tol(dtype))
    np.testing.assert_allclose(_np(hT.cpu()), _np(wh.cpu()), **_tol(dtype))


@pytest.mark.gpu
def test_ssd_scan_cuda_reads_strided_slices(cuda):
    """x, B, C as slices of one (B, S, d_inner + 2N) tensor, as mamba2_block
    hands them over: read in place, same result as contiguous copies."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, n = 2, 150, 4, 32, 16
    rng = np.random.default_rng(8)
    xbc = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    xbc = (xbc * 0.5).to(torch.bfloat16).to(cuda)
    _, dt, A, _, _ = (t.to(cuda) for t in _torch(_ssd_inputs(9, b, s, h, p, n), "bfloat16"))
    x = xbc[..., :h * p].reshape(b, s, h, p)
    Bm, Cm = xbc[..., h * p: h * p + n], xbc[..., h * p + n:]
    assert not x.is_contiguous()
    assert ssd.body(x, Bm, Cm) == "tc"  # the strided views keep the tensor cores
    before = ops.launch_counts().get("ssd_scan.tc", 0)
    y, hT = ops.ssd_scan(x, dt, A, Bm, Cm)
    wy, wh = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan.tc"] == before + 2
    assert torch.equal(y, wy) and torch.equal(hT, wh)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 64, 65, 700])
def test_ssd_scan_cuda_tc_body(cuda, s):
    """The tensor-core body at zamba2-1.2b's widths, around the chunk edges,
    with an initial state; one call counts once under ssd_scan and ssd_scan.tc."""
    from repro_torch.kernels import ssd_scan as ssd

    b, h, p, n = 1, 32, 128, 64
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _torch(_ssd_inputs(17, b, s, h, p, n), "bfloat16"))
    h0 = torch.from_numpy(np.random.default_rng(18).standard_normal((b, h, p, n))
                          .astype(np.float32)).to(cuda)
    assert ssd.body(x, Bm, Cm) == "tc"
    counts = ops.launch_counts()
    before = (counts.get("ssd_scan", 0), counts.get("ssd_scan.tc", 0))
    y, hT = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["ssd_scan"], counts["ssd_scan.tc"]) == (before[0] + 1, before[1] + 1)
    wy, wh = tref.ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=h0)
    np.testing.assert_allclose(_np(y.cpu()), _np(wy.cpu()), **_tol("bfloat16"))
    np.testing.assert_allclose(_np(hT.cpu()), _np(wh.cpu()), **_tol("bfloat16"))


@pytest.mark.gpu
def test_ssd_scan_cuda_tc_batches_and_wide_state(cuda):
    """Batch > 1, several heads per block (long S), N = 128 and P = 256, and
    S = 0 (the final state is the initial state)."""
    from repro_torch.kernels import ssd_scan as ssd

    # (2, 4200, 8, ...): 66 chunks, so four heads share a block
    for b, s, h, p, n in ((3, 300, 4, 64, 32), (2, 4200, 8, 64, 32), (1, 700, 2, 256, 128),
                          (2, 0, 2, 32, 16)):
        x, dt, A, Bm, Cm = (t.to(cuda) for t in _torch(_ssd_inputs(19, b, s, h, p, n),
                                                        "bfloat16"))
        h0 = torch.from_numpy(np.random.default_rng(20).standard_normal((b, h, p, n))
                              .astype(np.float32)).to(cuda)
        assert ssd.body(x, Bm, Cm) == "tc"
        y, hT = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, h0)
        torch.cuda.synchronize()
        wy, wh = tref.ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=h0)
        assert y.shape == (b, s, h, p)
        np.testing.assert_allclose(_np(y.cpu()), _np(wy.cpu()), **_tol("bfloat16"))
        np.testing.assert_allclose(_np(hT.cpu()), _np(wh.cpu()), **_tol("bfloat16"))
