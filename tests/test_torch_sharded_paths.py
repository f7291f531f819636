"""The DTensor-only branches that let every family's sharded path run on the
card host's torch (2.11), on the CPU:

  * on plain tensors nothing moved: the MoE router's expert share is the
    ``index_add_`` count, Mamba-2's ``dt`` softplus is ``F.softplus`` and
    the sLSTM block is the time loop, bit for bit (the loop and the count
    written out here as they stood before the branches);
  * each branch on DTensors of a one-rank fake group (every tensor whole on
    the rank, real values): the one-hot expert share equals the count
    exactly, the pointwise softplus and its gradient agree with
    ``F.softplus`` to f32 rounding, and each per-rank region (the sLSTM
    loop, the mLSTM's step and parallel form, Mamba-2's one-token step and
    causal conv) returns its plain function's values bit for bit;
  * the sharded prefill and two decode steps of xLSTM, zamba2, Mixtral and
    DeepSeek-V3 on a (2, 2) gloo mesh against the same run with no mesh
    (the sLSTM and mLSTM states, Mamba-2's step, the router's count).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.models import moe, ssm

import torch_dist_support as tds


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


@pytest.fixture
def one_rank():
    """A fake process group of one rank and its (1, 1) CPU mesh, and a
    function that makes a replicated DTensor of a plain tensor."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))

        def put(t):
            return None if t is None else distribute_tensor(t, mesh, [Replicate()] * 2,
                                                            src_data_rank=None)

        yield put
    finally:
        dist.destroy_process_group()


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


# ---------------------------------------------------------------------------
# the MoE router's expert share
# ---------------------------------------------------------------------------
def _routing(seed=0):
    cfg = reduced(get_config("mixtral-8x7b"))
    rng = np.random.default_rng(seed)
    p = {"router": _rand(rng, cfg.d_model, cfg.n_experts)}
    return cfg, p, _rand(rng, 64, cfg.d_model)


def test_router_share_on_plain_tensors_is_the_index_add():
    cfg, p, xt = _routing()
    gates, eidx, aux = moe._route(p, xt, cfg)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    me = probs.mean(0)
    ce = torch.zeros_like(me).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), device=xt.device)) / eidx.numel()
    assert torch.equal(aux, cfg.n_experts * torch.sum(me * ce))


def test_router_share_of_a_dtensor_is_the_count(one_rank):
    cfg, p, xt = _routing(1)
    _, eidx, _ = moe._route(p, xt, cfg)
    me = torch.softmax(xt.float() @ p["router"], dim=-1).mean(0)
    got = moe._expert_share(one_rank(eidx), one_rank(me))
    assert type(got).__name__ == "DTensor"
    assert torch.equal(got.full_tensor(), moe._expert_share(eidx, me))


# ---------------------------------------------------------------------------
# Mamba-2's dt softplus
# ---------------------------------------------------------------------------
_SOFTPLUS_X = torch.cat([torch.linspace(-40.0, 40.0, 2001),
                         _rand(np.random.default_rng(2), 4000, scale=4.0)])


def test_softplus_on_plain_tensors_is_f_softplus():
    assert torch.equal(ssm._softplus(_SOFTPLUS_X), F.softplus(_SOFTPLUS_X))


def test_softplus_of_a_dtensor_and_its_gradient(one_rank):
    x = _SOFTPLUS_X.clone().requires_grad_()
    xd = one_rank(_SOFTPLUS_X).requires_grad_()
    want = F.softplus(x)
    got = ssm._softplus(xd)
    assert type(got).__name__ == "DTensor"
    ulp = torch.finfo(torch.float32).eps * want.detach().abs().clamp(min=1.0)
    assert ((got.full_tensor() - want).abs() <= 2 * ulp).all()
    (gd,) = torch.autograd.grad(got.sum(), xd)
    (gw,) = torch.autograd.grad(want.sum(), x)
    assert (gd.full_tensor() - gw).abs().max() <= 2 * torch.finfo(torch.float32).eps


# ---------------------------------------------------------------------------
# the sLSTM block and the per-rank regions
# ---------------------------------------------------------------------------
def _slstm_before(p, x, state):
    """The sLSTM block's loop as it stood before its per-rank region."""
    b, s, d = x.shape
    wx = (x @ p["w_gates"]).float()
    c, n, hprev, m = (state[k] for k in ("c", "n", "h", "m"))
    rw = p["r_gates"].float()
    gb = p["g_bias"]
    hs = []
    for t in range(s):
        g = wx[:, t] + hprev @ rw + gb
        ig, fg, zg, og = g.chunk(4, dim=-1)
        logf = F.logsigmoid(fg)
        m_new = torch.maximum(logf + m, ig)
        i = torch.exp(ig - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(zg)
        n = f * n + i
        hprev = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, dim=1).to(x.dtype), (c, n, hprev, m)


@pytest.mark.parametrize("given_state", [False, True])
def test_slstm_block_on_plain_tensors_is_the_time_loop(given_state):
    cfg = reduced(get_config("xlstm-125m"))
    d = cfg.d_model
    rng = np.random.default_rng(3)
    p = {"w_gates": _rand(rng, d, 4 * d, scale=d ** -0.5),
         "r_gates": _rand(rng, d, 4 * d, scale=d ** -0.5), "g_bias": _rand(rng, 4 * d),
         "norm": {"scale": torch.ones(d)},
         "w_ff": {"w_gate": _rand(rng, d, 2 * d, scale=0.1), "w_up": _rand(rng, d, 2 * d, scale=0.1),
                  "w_out": _rand(rng, 2 * d, d, scale=0.1)}}
    x = _rand(rng, 2, 7, d)
    fresh = ssm.init_slstm_state(cfg, 2, "cpu")
    state = {k: v + (0.1 * _rand(rng, *v.shape) if given_state else 0) for k, v in fresh.items()}
    want_h, want_state = _slstm_before(p, x, {k: v.clone() for k, v in state.items()})
    carried = {k: v.clone() for k, v in state.items()}
    y, out = ssm.slstm_block(p, x, cfg, carried if given_state else None)
    from repro_torch.models import layers

    want_y = layers.apply_norm(p["norm"], want_h)
    want_y = want_y + layers.apply_mlp(p["w_ff"], want_y, "swiglu")
    assert torch.equal(y, want_y)
    if given_state:
        for key, val in zip(("c", "n", "h", "m"), want_state):
            assert torch.equal(out[key], val), key


def _regions(rng):
    """(name, plain function, region function, arguments) of each per-rank
    region; a DTensor's results come back whole for comparison."""
    b, s, h, dh, d, n = 2, 6, 4, 8, 16, 5
    wx, rw, gb = _rand(rng, b, s, 4 * d), _rand(rng, d, 4 * d, scale=0.3), _rand(rng, 4 * d)
    q, k, v = (_rand(rng, b, s, h, dh) for _ in range(3))
    i_pre, logf = _rand(rng, b, s, h), -torch.rand(b, s, h)
    C, nn_, m = _rand(rng, b, h, dh, dh), _rand(rng, b, h, dh).abs(), _rand(rng, b, h)
    q1, k1, v1, i1, f1 = q[:, :1], k[:, :1], v[:, :1], i_pre[:, :1], logf[:, :1]
    x = _rand(rng, b, 1, h, dh)
    dt, A = torch.rand(b, 1, h), -torch.rand(h)
    Bm, Cm, hs = _rand(rng, b, 1, n), _rand(rng, b, 1, n), _rand(rng, b, h, dh, n)
    xc, w, cs = _rand(rng, b, s, d), _rand(rng, 4, d), _rand(rng, b, 3, d)

    def mix(state):
        def run(*a):
            st = None if state is None else {"C": a[5].clone(), "n": a[6].clone(),
                                             "m": a[7].clone()}
            y = ssm._mlstm_mix(*a[:5], st)
            return (y,) if st is None else (y, st["C"], st["n"], st["m"])
        return run

    return [
        ("slstm_fresh", ssm._slstm_loop, ssm._slstm_scan, (wx, rw, gb, None, None, None, None)),
        ("slstm_state", ssm._slstm_loop, ssm._slstm_scan, (wx, rw, gb, *_rand(rng, 4, b, d))),
        ("mlstm_parallel", mix(None), mix(None), (q, k, v, i_pre, logf)),
        ("mlstm_prefill_state", mix("prefill"), mix("prefill"),
         (q, k, v, i_pre, logf, C, nn_, m)),
        ("mlstm_step", mix("step"), mix("step"), (q1, k1, v1, i1, f1, C, nn_, m)),
        ("mamba2_step", ssm._ssd_step, ssm._mamba2_step, (dt, x, Bm, Cm, A, hs)),
        ("causal_conv", ssm._causal_conv, ssm._causal_conv, (xc, w, None)),
        ("causal_conv_state", ssm._causal_conv, ssm._causal_conv, (xc, w, cs)),
    ]


@pytest.mark.parametrize("region", [r[0] for r in _regions(np.random.default_rng(4))])
def test_per_rank_region_is_its_plain_function(region, one_rank):
    name, plain, per_rank, args = next(r for r in _regions(np.random.default_rng(4))
                                       if r[0] == region)
    want = plain(*args)
    got = per_rank(*(one_rank(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == "DTensor"
        assert torch.equal(g.full_tensor(), w)


# ---------------------------------------------------------------------------
# the repaired paths on a (2, 2) gloo mesh
# ---------------------------------------------------------------------------
DECODE_ARCHS = ["xlstm-125m", "zamba2-1.2b", "mixtral-8x7b", "deepseek-v3-671b"]


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    out = tmp_path_factory.mktemp("decode")
    tds.spawn(tds.sharded_decode_case, 4, out, str(out), DECODE_ARCHS)
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(decoded, arch):
    got = np.load(decoded / f"{arch}-sharded.npz")
    want = np.load(decoded / f"{arch}-plain.npz")
    assert got.files == want.files
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-5 * max(
            1.0, float(np.abs(want[key]).max())), err_msg=key)
