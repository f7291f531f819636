"""Elastic checkpoints and the multi-rank launcher, on gloo ranks (CPU).

  * a checkpoint saved on 4 ranks ((data 4), fsdp) restores on 6
    ((data 3, model 2)), as ``tests/test_distribution.py`` re-shards the
    reference's: every leaf equal, placed by the specs of the new mesh;
  * across the packages both ways: the port's 4-rank save restored by the
    reference on (3, 2) host devices, and the reference's 4-device save
    restored by the port on 6 ranks; the leaf sums agree to 1e-6;
  * ``launch/train.py`` on 2 ranks (``RANK`` / ``WORLD_SIZE`` as torchrun
    sets them): its losses equal the 1-rank run's to 1e-5, and a 1-rank
    run resumes from its checkpoint onto the uninterrupted run's losses."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_support as sup

SUM_RTOL = 1e-6
LOSS_RTOL = 1e-5


def _sums(tree) -> dict:
    return {k: float(np.asarray(v, dtype=np.float64).sum()) for k, v in sup.paths(tree).items()}


def _spec_paths(tree, prefix=""):
    """{path: spec}: the specs' tuples are leaves."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _spec_paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, x in enumerate(tree)
                for p, v in _spec_paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _port_save(rank, world, ck, out):
    from repro_torch.configs import get_config, reduced
    from repro_torch.distribution import sharding as shd
    from repro_torch.models import bundle
    from repro_torch.training import optimizer as topt
    from repro_torch.training.checkpoint import CheckpointManager

    mb = bundle(reduced(get_config("smollm-135m")))
    m = sup.mesh((4,), ("data",))
    with shd.use_mesh(m, fsdp=True):
        params = mb.init(torch.Generator().manual_seed(7), device="cpu")
        ocfg = topt.AdamWConfig()
        state = topt.init(params, ocfg)
        saved = {k: sup.full(v) for k, v in sup.paths(params).items()}
        params = shd.distribute(params, shd.param_specs(params, m, True), m)
        state = shd.distribute(state, shd.opt_state_specs(params, state, m, True), m)
        CheckpointManager(ck).save(3, params, state, blocking=True)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(saved, f)


def _port_restore(rank, world, ck, out):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config, reduced
    from repro_torch.distribution import sharding as shd
    from repro_torch.models import bundle
    from repro_torch.training import optimizer as topt
    from repro_torch.training.checkpoint import CheckpointManager

    mb = bundle(reduced(get_config("smollm-135m")))
    m = sup.mesh((3, 2), ("data", "model"))  # a different topology
    with shd.use_mesh(m, fsdp=True):
        tmpl_p = mb.param_shapes()
        tmpl_o = topt.init(tmpl_p, topt.AdamWConfig())
        pspecs = shd.param_specs(tmpl_p, m, True)
        ospecs = shd.opt_state_specs(tmpl_p, tmpl_o, m, True)
        mgr = CheckpointManager(ck)
        assert mgr.latest_step() == 3
        params, state = mgr.restore(3, tmpl_p, tmpl_o, device="cpu", shardings=(pspecs, ospecs))
    flat, specs = sup.paths(params), _spec_paths(pspecs)
    for k, v in flat.items():
        want = shd.placements(specs[k], m)
        if isinstance(v, DTensor):
            assert tuple(v.placements) == want, k
        else:
            assert all(pl.is_replicate() for pl in want), k
    assert any(isinstance(v, DTensor) and any(pl.is_shard() for pl in v.placements)
               for v in flat.values())
    restored = {k: sup.full(v) for k, v in flat.items()}
    restored.update({"opt" + k: sup.full(v) for k, v in sup.paths(state).items()})
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(restored, f)


REF_RESTORE = """
import pickle
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.models import bundle
from repro.distribution import sharding as shd
from repro.training import optimizer as opt
from repro.training.checkpoint import CheckpointManager
mb = bundle(reduced(get_config("smollm-135m")))
mesh = jax.make_mesh((3, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
with shd.use_mesh(mesh, fsdp=True):
    tp = mb.param_shapes()
    to = jax.eval_shape(lambda p: opt.init(p, opt.AdamWConfig()), tp)
    pn = shd.named(shd.param_specs(tp, mesh, True), mesh)
    on = shd.named(shd.opt_state_specs(tp, to, mesh, True), mesh)
    params, _ = CheckpointManager({ck!r}).restore(3, tp, to, shardings=(pn, on))
def paths(t, pre=""):
    if isinstance(t, dict):
        return {{p: v for k in t for p, v in paths(t[k], pre + "/" + str(k)).items()}}
    if isinstance(t, (list, tuple)):
        return {{p: v for i, x in enumerate(t) for p, v in paths(x, pre + "/" + str(i)).items()}}
    return {{pre: t}}
with open({out!r}, "wb") as f:
    pickle.dump({{k: np.asarray(v) for k, v in paths(params).items()}}, f)
"""

REF_SAVE = """
import pickle
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.models import bundle
from repro.distribution import sharding as shd
from repro.training import optimizer as opt
from repro.training.checkpoint import CheckpointManager
mb = bundle(reduced(get_config("smollm-135m")))
mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
with shd.use_mesh(mesh, fsdp=True):
    params = mb.init(jax.random.key(7))
    state = opt.init(params, opt.AdamWConfig())
    pn = shd.named(shd.param_specs(params, mesh, True), mesh)
    params = jax.tree.map(jax.device_put, params, pn)
    CheckpointManager({ck!r}).save(3, params, state, blocking=True)
def paths(t, pre=""):
    if isinstance(t, dict):
        return {{p: v for k in t for p, v in paths(t[k], pre + "/" + str(k)).items()}}
    if isinstance(t, (list, tuple)):
        return {{p: v for i, x in enumerate(t) for p, v in paths(x, pre + "/" + str(i)).items()}}
    return {{pre: t}}
with open({out!r}, "wb") as f:
    pickle.dump({{k: np.asarray(v) for k, v in paths(params).items()}}, f)
"""


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The port's 4-rank save and the reference's 4-device save, each
    restored on 6 ranks / devices by both packages."""
    d = tmp_path_factory.mktemp("elastic")
    port_ck, ref_ck = str(d / "port-ck"), str(d / "ref-ck")
    saver = sup.start_reference(4, REF_SAVE.format(ck=ref_ck, out=str(d / "ref-saved.pkl")),
                                d / "ref-save.log")
    try:
        sup.spawn(_port_save, 4, d, port_ck, str(d / "port-saved.pkl"))
    finally:
        sup.finish_reference(saver, d / "ref-save.log")
    loader = sup.start_reference(6, REF_RESTORE.format(ck=port_ck,
                                                       out=str(d / "ref-restored.pkl")),
                                 d / "ref-restore.log")
    try:
        sup.spawn(_port_restore, 6, d, port_ck, str(d / "port-restored.pkl"))
        sup.spawn(_port_restore, 6, d, ref_ck, str(d / "port-restored-ref.pkl"))
    finally:
        sup.finish_reference(loader, d / "ref-restore.log")
    out = {}
    for name in ("port-saved", "port-restored", "ref-saved", "ref-restored",
                 "port-restored-ref"):
        with open(d / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_port_save_on_4_restores_on_6(checkpoints):
    saved, restored = checkpoints["port-saved"], checkpoints["port-restored"]
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    assert all(not np.any(v) for k, v in restored.items() if k.startswith("opt/m/"))


@pytest.mark.parametrize("saver,loader", [("port-saved", "ref-restored"),
                                          ("ref-saved", "port-restored-ref")])
def test_checkpoints_cross_the_packages_elastically(checkpoints, saver, loader):
    want, got = _sums(checkpoints[saver]), _sums(checkpoints[loader])
    assert set(want) <= set(got)
    for k in want:
        assert abs(got[k] - want[k]) <= SUM_RTOL * max(abs(want[k]), 1.0), k


# ---------------------------------------------------------------------------
# the launcher on 2 ranks
# ---------------------------------------------------------------------------
_RUN = ("import json, sys; from repro_torch.launch.train import parse_args, train; "
        "r = train(parse_args(sys.argv[1:])); "
        "print('LOSSES', json.dumps([r['losses'], r['start'], r['world']]))")
COMMON = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "8", "--seq",
          "16", "--lr", "3e-3", "--log-every", "100"]


def _launch(args, world, rdzv):
    env = dict(os.environ, PYTHONPATH=sup.SRC)
    procs = []
    for r in range(world):
        if world > 1:
            env = dict(env, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RUN] + args + (["--dist-init", f"file://{rdzv}"]
                                                   if world > 1 else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=sup.JOIN_TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    line = next(x for x in outs[0].splitlines() if x.startswith("LOSSES"))
    losses, start, w = json.loads(line[len("LOSSES "):])
    assert w == world
    # only rank 0 prints the log
    assert all("step" not in o and "arch=" not in o for o in outs[1:])
    return losses, start, outs[0]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    ck = str(d / "ck")
    one, _, _ = _launch(COMMON + ["--steps", "6"], 1, None)
    two, start2, log2 = _launch(COMMON + ["--steps", "4", "--ckpt-dir", ck], 2, d / "rdzv")
    resumed, start3, log3 = _launch(COMMON + ["--steps", "6", "--ckpt-dir", ck], 1, None)
    return one, (two, start2, log2), (resumed, start3, log3)


def test_two_ranks_train_as_one(launches):
    one, (two, start, log), _ = launches
    assert start == 0 and "mesh={'data': 2}" in log
    np.testing.assert_allclose(two, one[:4], rtol=LOSS_RTOL)


def test_one_rank_resumes_a_two_rank_checkpoint(launches):
    one, _, (resumed, start, log) = launches
    assert start == 4 and "resumed from step 3" in log
    np.testing.assert_allclose(resumed, one[4:], rtol=LOSS_RTOL)
