"""The kernels under autograd, on the CPU.  The reference has no backward
kernel (it differentiates its chunked jnp paths), so on the card the
flash-attention and SSD-scan kernels sit inside ``torch.autograd.Function``s
whose backward is plain PyTorch: ``ref.attention_bwd_ref`` (query-chunked)
and ``ref.ssd_scan_bwd_ref`` (the chunked scan recomputed under autograd).
Here those backwards are held to autograd through the plain forwards, the
Functions (whose CPU forward is the plain version) pass ``gradcheck``, two
planted faults in the attention backward's mask must be caught, the graph
guards behave, and remat wraps the training blocks only.  The Functions'
kernel forwards are held to the same on the card by the ``gpu`` tests of
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ssd_scan import SSDScan
from repro_torch.models import bundle, transformer
from repro_torch.tree import tree_leaves, tree_unflatten


@pytest.fixture(autouse=True)
def _restore_remat():
    mode = transformer.remat_mode()
    yield
    transformer.set_remat(mode)


def _rand(seed, *shapes, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype) for s in shapes]


#: (b, sq, sk, hq, hkv, d, dv, causal, window, q_chunk)
ATTN_CASES = [
    (2, 9, 9, 4, 2, 8, 8, True, None, 4),  # causal, Sq = Sk not a multiple of the chunk
    (1, 12, 12, 4, 1, 8, 8, True, 3, 5),  # sliding window, MQA
    (2, 5, 11, 4, 2, 8, 6, True, None, 2),  # causal Sq < Sk (ends aligned), D != Dv
    (2, 7, 13, 2, 2, 12, 8, False, None, 3),  # non-causal cross-attention, Sq != Sk
    (1, 10, 16, 6, 3, 8, 4, True, 4, 4),  # window with Sq < Sk
    (1, 6, 6, 4, 4, 24, 16, True, None, 512),  # MLA-like D 24 / Dv 16, one chunk
]


def _autograd_ref(q, k, v, dout, causal, window):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.attention_ref(*leaves, causal, window)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,dv,causal,window,chunk", ATTN_CASES)
def test_attention_bwd_ref_matches_autograd_f64(b, sq, sk, hq, hkv, d, dv, causal, window,
                                                chunk):
    q, k, v, dout = _rand(1, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv), (b, sq, hq, dv))
    want = _autograd_ref(q, k, v, dout, causal, window)
    got = ref.attention_bwd_ref(q, k, v, dout, causal, window, q_chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12)


def test_attention_bwd_ref_f32_and_bf16_return_their_dtypes():
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v, dout = _rand(2, (1, 16, 4, 16), (1, 16, 2, 16), (1, 16, 2, 16), (1, 16, 4, 16),
                              dtype=dtype)
        want = _autograd_ref(*(t.double() for t in (q, k, v, dout)), True, None)
        got = ref.attention_bwd_ref(q, k, v, dout, True, None, q_chunk=5)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window,sq,sk", [(True, None, 5, 7), (True, 2, 6, 6),
                                                 (False, None, 4, 6)])
def test_flash_function_gradcheck(causal, window, sq, sk):
    q, k, v = (t.requires_grad_() for t in _rand(3, (1, sq, 2, 4), (1, sk, 1, 4), (1, sk, 1, 3)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window), (q, k, v))


def _planted_error(bwd, causal, window, sq, sk):
    """max error of a backward against autograd through attention_ref, over
    the largest gradient."""
    q, k, v, dout = _rand(4, (1, sq, 4, 8), (1, sk, 2, 8), (1, sk, 2, 8), (1, sq, 4, 8))
    want = _autograd_ref(q, k, v, dout, causal, window)
    got = bwd(q, k, v, dout)
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def test_planted_window_off_by_one_is_caught():
    """A backward whose window is one row short (or long) fails the
    comparison that the true one passes."""
    assert _planted_error(lambda *a: ref.attention_bwd_ref(*a, True, 4, q_chunk=3),
                          True, 4, 12, 12) < 1e-12
    for off in (-1, 1):
        assert _planted_error(lambda *a: ref.attention_bwd_ref(*a, True, 4 + off, q_chunk=3),
                              True, 4, 12, 12) > 1e-2


def test_planted_causal_offset_ignoring_sk_minus_sq_is_caught(monkeypatch):
    """A backward whose causal mask starts query i at key i (not at
    i + Sk - Sq) fails against the forward's end-aligned mask."""
    real = ref._attention_mask

    def unaligned(sq, sk, causal, window, device, q0=0, rows=None):
        return real(sk, sk, causal, window, device, q0, rows)  # offset Sk - Sq dropped

    want_err = _planted_error(lambda *a: ref.attention_bwd_ref(*a, True, None, q_chunk=2),
                              True, None, 5, 9)
    assert want_err < 1e-12
    q, k, v, dout = _rand(4, (1, 5, 4, 8), (1, 9, 2, 8), (1, 9, 2, 8), (1, 5, 4, 8))
    want = _autograd_ref(q, k, v, dout, True, None)
    monkeypatch.setattr(ref, "_attention_mask", unaligned)
    got = ref.attention_bwd_ref(q, k, v, dout, True, None, q_chunk=2)
    assert max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)) > 1e-2


def _ssd_views(seed, b, s, h, p, n, dtype=torch.float32):
    """x, B, C as strided views of one conv output (mamba2_block's layout),
    dt = softplus(N(0,1)), A = -exp(0.3 N(0,1)), an initial state."""
    g = torch.Generator().manual_seed(seed)
    conv = (torch.randn((b, s, h * p + 2 * n + 3), generator=g) * 0.5).to(dtype)
    x = conv[..., :h * p].reshape(b, s, h, p)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.exp(torch.randn((h,), generator=g) * 0.3)
    h0 = torch.randn((b, h, p, n), generator=g)
    return conv, x, dt, A, conv[..., h * p:h * p + n], conv[..., h * p + n:h * p + 2 * n], h0


@pytest.mark.parametrize("s", [100, 64, 17])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_bwd_ref_matches_autograd_on_strided_views(s, with_state):
    conv, x, dt, A, B, C, h0 = _ssd_views(5, 2, s, 3, 8, 4)
    h0 = h0 if with_state else None
    leaves = [t.detach().clone().requires_grad_() if t is not None else None
              for t in (x, dt, A, B, C, h0)]
    y, final = ref.ssd_scan_ref(*leaves)
    dy, dfinal = torch.randn_like(y), torch.randn_like(final)
    want = torch.autograd.grad((y, final), [t for t in leaves if t is not None], (dy, dfinal))
    got = [g for g in ref.ssd_scan_bwd_ref(x, dt, A, B, C, h0, dy, dfinal) if g is not None]
    assert len(got) == len(want) == (6 if with_state else 5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_ssd_function_backward_on_views_accumulates_into_the_conv_output():
    conv, *_ = _ssd_views(6, 2, 70, 2, 16, 8)
    grads = []
    for use_fn in (True, False):
        c = conv.detach().clone().requires_grad_()
        x, B, C = c[..., :32].reshape(2, 70, 2, 16), c[..., 32:40], c[..., 40:48]
        _, _, dt, A, *_ = _ssd_views(6, 2, 70, 2, 16, 8)
        y, _ = (SSDScan.apply if use_fn else ref.ssd_scan_ref)(x, dt, A, B, C, None)
        grads.append(torch.autograd.grad(y.square().sum(), c)[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-4,
                               atol=1e-4 * float(grads[1].abs().max()))
    assert not grads[0][..., 48:].any()  # the columns no view reads


def test_ssd_scan_chunked_ref_equals_the_recurrence():
    _, x, dt, A, B, C, h0 = _ssd_views(7, 2, 130, 3, 8, 4)
    y, final = ref.ssd_scan_chunked_ref(x, dt, A, B, C, h0)
    wy, wfinal = ref.ssd_scan_ref(x, dt, A, B, C, h0)
    np.testing.assert_allclose(y.numpy(), wy.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(final.numpy(), wfinal.numpy(), rtol=1e-4, atol=1e-5)


def test_cpu_dispatch_under_grad_is_plain_autograd_without_launches():
    ops.reset_launch_counts()
    q, k, v = (t.float().requires_grad_() for t in _rand(8, (1, 8, 2, 4), (1, 8, 1, 4),
                                                          (1, 8, 1, 4)))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    _, x, dt, A, B, C, _ = _ssd_views(9, 1, 10, 2, 4, 4)
    y, _ = ops.ssd_scan(x, dt.requires_grad_(), A, B, C)
    assert y.grad_fn is not None
    assert ops.launch_counts() == {}


def test_graph_guards():
    a, b = torch.zeros(2, requires_grad=True), torch.zeros(2)
    assert _build.wants_graph(b, a, None)
    assert not _build.wants_graph(b, None)
    with torch.no_grad():
        assert not _build.wants_graph(a)
        _build.forbid_graph("k", a)  # no graph is wanted under no_grad
    with pytest.raises(RuntimeError, match="k: the kernel has no backward"):
        _build.forbid_graph("k", b, a)


def _reduced_smollm():
    cfg = reduced(get_config("smollm-135m"), n_layers=3)
    mb = bundle(cfg)
    params = mb.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    return mb, params, {"tokens": toks}


def test_remat_recomputes_each_layer_group_block_once(monkeypatch):
    """Under set_remat("block") a training step calls attention twice per
    layer (forward, and the backward's recompute), the same loss and
    gradients as without; a prefill with a cache is never wrapped."""
    mb, params, batch = _reduced_smollm()
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for mode in (None, "block"):
        transformer.set_remat(mode)
        calls.clear()
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = mb.loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        out[mode] = (float(loss.detach()), grads, len(calls))
    assert out[None][2] == 3 and out["block"][2] == 6
    assert out[None][0] == pytest.approx(out["block"][0], rel=1e-6)
    for a, b in zip(out[None][1], out["block"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    # a prefill writes its cache in place: differentiated under remat, a
    # wrapped block would run again and advance the cache index twice
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    logits, cache = mb.prefill_fn(tree_unflatten(params, leaves), batch, max_len=16)
    torch.autograd.grad(logits.sum(), leaves, allow_unused=True)
    assert int(cache["groups"][0]["attn"]["index"][0]) == 12


def test_set_remat_rejects_unknown_modes():
    with pytest.raises(ValueError):
        transformer.set_remat("full")
