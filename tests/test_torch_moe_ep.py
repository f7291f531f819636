"""The port's expert-parallel MoE (``set_moe_impl("alltoall")``,
``distribution/moe_ep.py``) on gloo ranks, held to the reference's
``moe_ep.apply_moe_alltoall`` on the same mesh (Auto axes) and to the
port's unsharded dispatch, from the same weights: the loss within 1e-5
relative and every gradient leaf (the experts' and the router's among
them) within 1e-4 of its max.  Reduced Mixtral and DeepSeek-V3 (routed and
shared experts) on (data 2, model 2) and (model 4), and the expert +
tensor hybrid: 2 experts on model 4, so each expert's F is split 2 ways."""
import pytest

import torch_dist_support as sup

MESHES = {
    "data2_model2": {"mesh": ((2, 2), ("data", "model")), "steps": False},
    "model4": {"mesh": ((1, 4), ("data", "model")), "steps": False},
}
RUNS = {
    "mixtral-8x7b": ("mixtral-8x7b", {"capacity_factor": 8.0}, MESHES),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"capacity_factor": 8.0}, MESHES),
    "hybrid": ("mixtral-8x7b", {"capacity_factor": 8.0, "n_experts": 2},
               {"model4": MESHES["model4"]}),
}
CASES = [(run, name) for run, (_, _, meshes) in RUNS.items() for name in meshes]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {run: sup.run_parity(tmp_path_factory.mktemp(run), arch, meshes, overrides,
                                moe_impl="alltoall")
            for run, (arch, overrides, meshes) in RUNS.items()}


@pytest.mark.parametrize("run,name", CASES)
def test_alltoall_loss_matches(runs, run, name):
    sup.check_loss(*runs[run], name)


@pytest.mark.parametrize("run,name", CASES)
def test_alltoall_gradients_match(runs, run, name):
    ref, port = runs[run]
    sup.check_grads(ref, port, name)
    experts = [k for k in port[name]["grads"] if "/experts/" in k]
    routers = [k for k in port[name]["grads"] if k.endswith("/router")]
    assert experts and routers


def test_rank_slices_tile_the_experts():
    """The hybrid's 4 rank slices of 2 experts are each expert's F halves."""
    import torch

    from repro_torch.distribution.moe_ep import _rank_slice

    g = torch.Generator().manual_seed(0)
    wg, wu = torch.randn(2, 8, 6, generator=g), torch.randn(2, 8, 6, generator=g)
    wo = torch.randn(2, 6, 8, generator=g)
    parts = [_rank_slice(wg, wu, wo, r, 2) for r in range(4)]
    for e in range(2):
        assert torch.equal(torch.cat([parts[2 * e][0][0], parts[2 * e + 1][0][0]], -1), wg[e])
        assert torch.equal(torch.cat([parts[2 * e][1][0], parts[2 * e + 1][1][0]], -1), wu[e])
        assert torch.equal(torch.cat([parts[2 * e][2][0], parts[2 * e + 1][2][0]], 0), wo[e])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_one_rank_mesh_runs_the_region_on_plain_tensors(arch):
    """On a mesh of one rank the tensors stay plain and the per-rank code
    runs on them: equal to dispatch where no token is dropped."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.distribution import moe_ep, sharding
    from repro_torch.models import bundle, moe
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch), capacity_factor=8.0)
    params = bundle(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    p = tree_map(lambda t: t[0], next(g for g in params["groups"] if "moe" in g)["moe"])
    xt = torch.randn(32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    gates, eidx, _ = moe._route(p, xt, cfg)
    with sharding.use_mesh(sharding.MeshShape(("data", "model"), (1, 1))):
        got = moe_ep.apply_moe_alltoall(p, xt, gates, eidx, cfg)
    want = moe._apply_dispatch(p, xt, gates, eidx, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # no mesh: the dispatch itself
    assert torch.equal(moe_ep.apply_moe_alltoall(p, xt, gates, eidx, cfg), want)
