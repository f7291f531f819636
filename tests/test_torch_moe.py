"""Port MoE layer (``repro_torch.models.moe``) vs the reference's dispatch
mode on the same weights and tokens (f32, CPU): the router's gates, experts
and auxiliary loss, the grouped capacity-bounded dispatch with tokens
dropped, and the shared expert."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.models import moe

# f32 on the CPU in both frameworks: the same math summed in another order;
# observed differences are ~1e-7, the bound leaves two orders of magnitude
TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(name, **over):
    jcfg = reduced(get_config(name), **over)
    tcfg = t_reduced(t_get_config(name), **over)
    jp = jmoe.init_moe(jax.random.key(0), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    return jcfg, tcfg, jp, tp


def _x(t, d, seed=1):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


def _kept_slots(jcfg, eidx, t):
    """Top-k slots that find room in their expert's buffer, group by group
    (the reference's capacity rule, counted here independently)."""
    g = jmoe._group_count(t)
    tg = t // g
    cap = min(max(4, int(np.ceil(tg * jcfg.experts_per_token / jcfg.n_experts
                                  * jcfg.capacity_factor))), tg * jcfg.experts_per_token)
    e = np.asarray(eidx).reshape(g, -1)
    return sum(min(int((row == x).sum()), cap) for row in e for x in range(jcfg.n_experts))


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_route_matches_reference(name):
    jcfg, tcfg, jp, tp = _pair(name)
    x = _x(300, jcfg.d_model)
    jg, je, ja = jmoe._route(jp, jnp.asarray(x), jcfg)
    tg, te, ta = moe._route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("t", [300, 2048])  # one group; two groups of 1024
def test_dispatch_drops_tokens_as_reference(t):
    """capacity_factor 1.0: every expert's buffer holds Tg*k/E slots, so the
    busier experts drop tokens; the port drops the same ones."""
    jcfg, tcfg, jp, tp = _pair("mixtral-8x7b", capacity_factor=1.0)
    assert jmoe._group_count(t) == moe._group_count(t) == (1 if t < 2048 else 2)
    x = _x(t, jcfg.d_model, seed=2)
    jg, je, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    kept = _kept_slots(jcfg, je, t)
    assert kept < t * jcfg.experts_per_token  # some tokens are dropped
    want = np.asarray(jmoe._apply_dispatch(jp, jnp.asarray(x), jg, je, jcfg))
    got = moe._apply_dispatch(tp, torch.from_numpy(x), torch.from_numpy(np.array(jg)),
                              torch.from_numpy(np.array(je)).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a token whose every slot was dropped contributes zero
    assert int((np.abs(want).sum(-1) == 0).sum()) == int((got.abs().sum(-1) == 0).sum())


@pytest.mark.parametrize("name,cf", [("mixtral-8x7b", 1.0), ("deepseek-v3-671b", 1.0),
                                     ("deepseek-v3-671b", 1.25)])
def test_apply_moe_matches_reference(name, cf):
    """(y, aux) end to end, DeepSeek with its shared expert, over (B, S, D)
    with two groups."""
    jcfg, tcfg, jp, tp = _pair(name, capacity_factor=cf)
    assert ("shared" in tp) == (name == "deepseek-v3-671b")
    x = _x(2 * 1024, jcfg.d_model, seed=3).reshape(2, 1024, -1)
    jy, ja = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, ta = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


def test_shared_expert_is_added_to_every_token():
    jcfg, tcfg, jp, tp = _pair("deepseek-v3-671b")
    x = torch.from_numpy(_x(16, jcfg.d_model, seed=4)).reshape(1, 16, -1)
    with_shared, _ = moe.apply_moe(tp, x, tcfg)
    without, _ = moe.apply_moe({k: v for k, v in tp.items() if k != "shared"}, x, tcfg)
    f = tp["shared"]["w_gate"].shape[1]
    assert f == tcfg.moe_d_ff * tcfg.n_shared_experts
    h = torch.nn.functional.silu(x @ tp["shared"]["w_gate"]) * (x @ tp["shared"]["w_up"])
    np.testing.assert_allclose((with_shared - without).numpy(),
                               (h @ tp["shared"]["w_out"]).numpy(), **TOL)
