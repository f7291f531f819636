"""The port's sharding rules (``distribution/sharding.py``), collective
model and meshes against the reference's, with no devices:

  * ``param_specs`` and ``opt_state_specs`` (f32 and int8 moments) equal
    the reference's PartitionSpecs entry by entry for every arch of
    ``configs.ARCHS`` at full shapes (meta tensors on the port's side,
    ``param_shapes()`` on the reference's) on (16,16), (2,16,16), (2,2)
    and (4,), fsdp on and off: both read only a mesh's axis names and sizes;
  * ``batch_specs`` and ``cache_specs`` on a table of shapes;
  * the activation rules: divisibility, and the first logical axis wins;
  * the ring identities and ``CollectiveModel.summary()`` on a grid;
  * the production meshes on torch's fake process group;
  * outside a mesh (and on a mesh of one rank) the hinted forward is bit
    for bit the forward with every hint removed."""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_config as jget_config
from repro.distribution import collectives as jco
from repro.distribution import sharding as jshd
from repro.models import bundle as jbundle
from repro.training import optimizer as jopt
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.distribution import collectives as co
from repro_torch.distribution import sharding as shd
from repro_torch.models import bundle, layers
from repro_torch.training import optimizer as topt

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4": ((4,), ("data",))}


def _jmesh(shape, names):
    """A mesh-like with the two attributes the reference's rules read."""
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _flat(tree, is_leaf):
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], is_leaf)]
    return [x for v in tree for x in _flat(v, is_leaf)]


def _jspecs(tree):
    from jax.sharding import PartitionSpec as P

    return [tuple(s) for s in _flat(tree, lambda n: isinstance(n, P))]


def _tspecs(tree):
    return _flat(tree, lambda n: isinstance(n, tuple))


def test_archs_are_the_references():
    assert tuple(ARCHS) == tuple(JARCHS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_opt_state_specs_match_the_reference(arch, mesh):
    shape, names = MESHES[mesh]
    jm, tm = _jmesh(shape, names), shd.MeshShape(names, shape)
    jp = jbundle(jget_config(arch)).param_shapes()
    tp = bundle(get_config(arch)).param_shapes()
    for fsdp in (True, False):
        want = _jspecs(jshd.param_specs(jp, jm, fsdp))
        assert _tspecs(shd.param_specs(tp, tm, fsdp)) == want
        for moment in ("float32", "int8"):
            jo = jax.eval_shape(lambda p: jopt.init(p, jopt.AdamWConfig(moment_dtype=moment)), jp)
            to = topt.init(tp, topt.AdamWConfig(moment_dtype=moment))
            want = _jspecs(jshd.opt_state_specs(jp, jo, jm, fsdp))
            assert _tspecs(shd.opt_state_specs(tp, to, tm, fsdp)) == want, (fsdp, moment)


SHAPES = [(8,), (8, 16), (6, 16), (3, 5), (1, 128), (32, 4, 2), (2, 8, 16, 4), (16, 16, 2, 4),
          (4, 2, 512, 8, 64), (1,), ()]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_match_the_reference(mesh):
    shape, names = MESHES[mesh]
    jm, tm = _jmesh(shape, names), shd.MeshShape(names, shape)
    jtree = {f"x{i}": jax.ShapeDtypeStruct(s, np.float32) for i, s in enumerate(SHAPES)}
    ttree = {f"x{i}": torch.empty(s, device="meta") for i, s in enumerate(SHAPES)}
    assert _tspecs(shd.batch_specs(ttree, tm)) == _jspecs(jshd.batch_specs(jtree, jm))
    for batch_size in (1, 2, 4, 8, 16, 32):
        assert (_tspecs(shd.cache_specs(ttree, tm, batch_size))
                == _jspecs(jshd.cache_specs(jtree, jm, batch_size))), batch_size


@pytest.mark.parametrize("shape,axes,want", [
    # the batch over both data axes, heads over model
    ((4, 8, 6, 16), ("batch", "seq", "heads", None), (("pod", "data"), None, "model", None)),
    # a batch of 3 does not divide 2 x 2: replicated
    ((3, 8, 6, 16), ("batch", "seq", "heads", None), (None, None, "model", None)),
    # 5 heads do not divide model 2
    ((4, 8, 5, 16), ("batch", "seq", "heads", None), (("pod", "data"), None, None, None)),
    # the first logical axis wins model
    ((4, 8, 16), ("batch", "heads", "mlp"), (("pod", "data"), "model", None)),
    # ... unless it does not divide: then the next one takes it
    ((4, 7, 16), ("batch", "heads", "mlp"), (("pod", "data"), None, "model")),
    ((4, 8, 512), ("batch", "seq", "vocab"), (("pod", "data"), None, "model")),
])
def test_activation_rules(shape, axes, want):
    mesh = shd.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert shd.logical_spec(shape, axes, mesh, shd.DEFAULT_RULES) == want
    # sequence parallelism moves seq onto model, where it is free
    rules = dict(shd.DEFAULT_RULES, seq="model")
    if axes[1] == "seq" and shape[1] % 2 == 0:
        assert shd.logical_spec(shape, axes, mesh, rules)[1] == "model"


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = shd.MeshShape(("pod", "data", "model"), (2, 4, 2))
    assert shd.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0),
                                                                      Shard(2))
    assert shd.placements((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    # a shard over one rank is a replica
    assert shd.placements(("pod",), shd.MeshShape(("pod", "data"), (1, 4))) == (
        Replicate(), Replicate())
    with pytest.raises(ValueError):
        shd.placements((("data", "pod"),), mesh)


def test_constrain_leaves_plain_tensors_alone():
    x = torch.randn(4, 8, 6, 16)
    assert shd.constrain(x, ("batch", "seq", "heads", None)) is x
    with shd.use_mesh(shd.MeshShape(("data", "model"), (2, 2))):
        assert shd.current()["mesh"].sizes == (2, 2)
        assert shd.constrain(x, ("batch", "seq", "heads", None)) is x
    assert shd.current() is None


def test_ring_identities():
    n, b = 16, 1e9
    assert co.ring_all_reduce(b, n) == co.all_gather(b, n) + co.reduce_scatter(b, n)
    assert co.ring_all_reduce(b, 1) == 0.0
    assert co.all_to_all(b, n) < co.all_gather(b, n)


@pytest.mark.parametrize("tp,dp", [(1, 1), (1, 16), (16, 1), (16, 16), (8, 32), (4, 2)])
def test_collective_model_matches_the_reference(tp, dp):
    for layers_, d, f, pb, act in [(30, 576, 1536, 2 * 135e6, 2 * 4096 * 576),
                                   (88, 12288, 28672, 2 * 123e9, 2 * 32768 * 12288)]:
        kw = dict(n_layers=layers_, d_model=d, d_ff=f, params_bytes=pb, tp=tp, dp=dp,
                  act_bytes_per_layer=act)
        assert co.CollectiveModel(**kw).summary() == jco.CollectiveModel(**kw).summary()
    for nbytes in (0.0, 1.0, 3e9):
        for n in (1, 2, 16, 512):
            for name in ("ring_all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
                assert getattr(co, name)(nbytes, n) == getattr(jco, name)(nbytes, n)


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_meshes_on_a_fake_process_group(multi_pod, world, monkeypatch):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro.launch import mesh as jmesh_mod
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, production_shape

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1, world_size=world)
    try:
        m = make_production_mesh(multi_pod=multi_pod, device="cpu")
        shape, names = production_shape(multi_pod)
        assert tuple(m.shape) == shape and m.mesh_dim_names == names
        assert tuple(m.get_coordinate()) == tuple(s - 1 for s in shape)
        # the reference's shape and axis names, as it asks JAX for them
        monkeypatch.setattr(jmesh_mod.jax, "make_mesh", lambda s, a: (tuple(s), tuple(a)))
        assert jmesh_mod.make_production_mesh(multi_pod=multi_pod) == (shape, names)
        h = make_host_mesh("cpu")
        assert tuple(h.shape) == (world,) and h.mesh_dim_names == ("data",)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_hints_leave_the_forward_bit_equal(arch, monkeypatch):
    cfg = reduced(get_config(arch))
    mb = bundle(cfg)
    params = mb.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": tokens.to(torch.int32)}
    hinted = mb.model.forward(params, batch)[0]
    with shd.use_mesh(shd.MeshShape(("data", "model"), (1, 1))):
        one_rank = mb.model.forward(params, batch)[0]
    monkeypatch.setattr(layers, "hint", lambda x, *axes: x)
    bare = mb.model.forward(params, batch)[0]
    assert torch.equal(hinted, bare) and torch.equal(one_rank, bare)
