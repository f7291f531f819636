"""GPipe (``distribution/pipeline.py``) on gloo ranks: the ports of
``tests/test_pipeline.py``'s ``test_gpipe_matches_sequential`` on
(pod 2, data 2) and (pod 4), and of ``test_gpipe_single_stage_fallback``;
each also held to the reference's ``gpipe`` output on the same weights
(drawn in numpy) on the same mesh shape (Auto axes)."""
import pickle

import numpy as np
import pytest
import torch

import torch_dist_support as sup

D, L, MB, NM = 16, 8, 4, 6
MESHES = {"pod2_data2": ((2, 2), ("pod", "data")), "pod4": ((4,), ("pod",)),
          "pod1_data4": ((1, 4), ("pod", "data"))}

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.distribution.pipeline import gpipe
with open({path!r} + "/inputs.pkl", "rb") as f:
    w, x = pickle.load(f)
def stage_fn(pw, h):
    return jax.lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None), h, pw)[0]
out = {{}}
for name, (shape, names) in {meshes!r}.items():
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    s = mesh.shape["pod"]
    with mesh:
        y = jax.jit(lambda p, x: gpipe(stage_fn, p, x, mesh=mesh, n_micro={nm}))(
            jnp.asarray(w.reshape(s, -1, {d}, {d})), jnp.asarray(x))
    out[name] = np.asarray(y)
with open({path!r} + "/ref.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _stage_fn(pw, h):
    for wi in pw:
        h = torch.tanh(h @ wi)
    return h


def _ranks(rank, world, path):
    from repro_torch.distribution.pipeline import gpipe

    with open(f"{path}/inputs.pkl", "rb") as f:
        w, x = (torch.from_numpy(a) for a in pickle.load(f))
    out = {}
    for name, (shape, names) in MESHES.items():
        m = sup.mesh(shape, names)
        s = dict(zip(names, shape))["pod"]
        out[name] = gpipe(_stage_fn, w.reshape(s, -1, D, D), x, mesh=m, n_micro=NM).numpy()
    with open(f"{path}/port{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpipe")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((NM, MB, D)).astype(np.float32)
    with open(path / "inputs.pkl", "wb") as f:
        pickle.dump((w, x), f)
    proc = sup.start_reference(4, REFERENCE.format(path=str(path), meshes=MESHES, nm=NM, d=D),
                               path / "ref.log")
    try:
        sup.spawn(_ranks, 4, path, str(path))
    finally:
        sup.finish_reference(proc, path / "ref.log")
    h = torch.from_numpy(x)
    for i in range(L):
        h = torch.tanh(h @ torch.from_numpy(w[i]))
    ports = []
    for r in range(4):
        with open(path / f"port{r}.pkl", "rb") as f:
            ports.append(pickle.load(f))
    with open(path / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return h.numpy(), ports, ref


@pytest.mark.parametrize("name", ["pod2_data2", "pod4"])
def test_gpipe_matches_sequential(runs, name):
    seq, ports, ref = runs
    for port in ports:  # every rank returns y
        np.testing.assert_allclose(port[name], seq, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-5, atol=1e-5)


def test_gpipe_single_stage_fallback(runs):
    seq, ports, ref = runs
    for port in ports:
        np.testing.assert_allclose(port["pod1_data4"], seq, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port["pod1_data4"], ref["pod1_data4"], rtol=1e-5, atol=1e-5)


def test_gpipe_single_stage_needs_no_process_group():
    """One stage never touches a group: a mesh shape alone will do."""
    from repro_torch.distribution import sharding
    from repro_torch.distribution.pipeline import gpipe

    g = torch.Generator().manual_seed(0)
    w = torch.randn(1, 2, 8, 8, generator=g) * 0.3
    x = torch.randn(3, 4, 8, generator=g)
    y = gpipe(_stage_fn, w, x, mesh=sharding.MeshShape(("pod", "data"), (1, 2)), n_micro=3)
    torch.testing.assert_close(y, torch.tanh(torch.tanh(x @ w[0, 0]) @ w[0, 1]))
