"""The port's training substrate on the CPU: the counterparts of the ten
tests of ``tests/test_training.py`` (same config, data and optimizer
settings, the port's own seeded weights), the data pipeline and the LR
schedule against the reference's bit for bit, checkpoints restored across
the two packages in both directions, and the ``launch/train_small.py`` twin
against ``examples/train_small.py``.

Every test restores what it changes: both packages' ``set_remat``
(``make_train_step`` sets it process-wide, as the reference's does) and the
reference's ``kops.set_impl``; ``sys.argv`` through ``monkeypatch``; files
only under ``tmp_path``.
"""
import importlib.util
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.kernels import ops as kops
from repro.models import bundle as jbundle, transformer as jtransformer
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_loop import TrainConfig as JTrainConfig, make_train_step as j_make
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as train_launch, train_small
from repro_torch.models import bundle, transformer
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data as data_lib
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_process_state():
    impl = (kops.get_impl(), kops._IMPL["interpret"])
    remat = (transformer.remat_mode(), jtransformer._REMAT["mode"])
    yield
    kops.set_impl(*impl)
    transformer.set_remat(remat[0])
    jtransformer.set_remat(remat[1])


def _cfg():
    return reduced(get_config("smollm-135m"), n_layers=2, d_model=64, vocab_size=128)


def _setup(moment_dtype="float32", microbatch=0, remat=False, steps=25):
    mb = bundle(_cfg())
    params = mb.init(torch.Generator().manual_seed(0), device="cpu")
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=200, moment_dtype=moment_dtype)
    state = opt.init(params, ocfg)
    step_fn = make_train_step(mb, ocfg, TrainConfig(microbatch=microbatch, remat=remat))
    dcfg = data_lib.DataConfig(vocab_size=128, seq_len=32, global_batch=8)
    return mb, params, state, step_fn, dcfg, steps


def _run(params, state, step_fn, dcfg, steps):
    losses = []
    for i in range(steps):
        params, state, m = step_fn(params, state, data_lib.get_batch(dcfg, i, device="cpu"))
        losses.append(float(m["loss"]))
    return params, state, losses


def _assert_trees_close(a, b, atol=1e-5, rtol=1e-4):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# counterparts of tests/test_training.py
# ---------------------------------------------------------------------------
def test_loss_decreases():
    mb, params, state, step_fn, dcfg, steps = _setup()
    _, _, losses = _run(params, state, step_fn, dcfg, steps)
    assert losses[-1] < losses[0] * 0.9
    assert all(np.isfinite(l) for l in losses)


def test_grad_accumulation_matches_full_batch():
    """microbatched grads == full-batch grads (same update trajectory)."""
    mb, params, state, _, dcfg, _ = _setup()
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=200)
    full = make_train_step(mb, ocfg, TrainConfig(microbatch=0, remat=False))
    micro = make_train_step(mb, ocfg, TrainConfig(microbatch=2, remat=False))
    batch = data_lib.get_batch(dcfg, 0, device="cpu")
    p1, _, m1 = full(params, state, batch)
    p2, _, m2 = micro(params, state, batch)
    _assert_trees_close(p1, p2)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)


def test_remat_matches_no_remat():
    mb, params, state, _, dcfg, _ = _setup()
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=200)
    batch = data_lib.get_batch(dcfg, 0, device="cpu")
    plain = make_train_step(mb, ocfg, TrainConfig(remat=False))
    p1, _, _ = plain(params, state, batch)
    rematted = make_train_step(mb, ocfg, TrainConfig(remat=True))
    assert transformer.remat_mode() == "block"
    p2, _, _ = rematted(params, state, batch)
    _assert_trees_close(p1, p2)


def test_int8_optimizer_still_learns():
    mb, params, _, _, dcfg, _ = _setup()
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=200, moment_dtype="int8")
    state = opt.init(params, ocfg)
    step_fn = make_train_step(mb, ocfg, TrainConfig(remat=False))
    _, state, losses = _run(params, state, step_fn, dcfg, 30)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.98  # quantized moments learn (slower)
    # the int8 state is int8: {"q": int8, "scale": f32} per leaf
    assert any(l.dtype == torch.int8 for l in tree_leaves(state["m"]))
    assert all(set(m) == {"q", "scale"} for m in opt._moment_leaves(state["m"]))


def test_int8_roundtrip_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)) * 0.03
    enc = opt._encode_moment(x, "int8")
    dec = opt._decode_moment(enc, x.shape, "int8")
    err = float((dec - x).abs().max())
    assert err < float(x.abs().max()) / 100  # <1% of range per row


def test_checkpoint_roundtrip_and_resume(tmp_path):
    mb, params, state, step_fn, dcfg, _ = _setup()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    params1, state1, _ = _run(params, state, step_fn, dcfg, 5)
    mgr.save(5, params1, state1)
    # continue 3 more steps -> reference trajectory
    ref_params, _, ref_losses = _run(params1, state1, step_fn, dcfg, 3)
    # "crash"; restore onto shape-only templates and resume: the same trajectory
    assert mgr.latest_step() == 5
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    p2, s2 = mgr.restore(5, tree_map(meta, params1), tree_map(meta, state1), device="cpu")
    res_params, _, res_losses = _run(p2, s2, step_fn, dcfg, 3)
    np.testing.assert_allclose(ref_losses, res_losses, rtol=1e-6)
    for a, b in zip(tree_leaves(ref_params), tree_leaves(res_params)):
        assert torch.equal(a, b)


def test_checkpoint_atomic_and_gc(tmp_path):
    _, params, state, _, _, _ = _setup()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, params, state)
    assert mgr.all_steps() == [3, 4]  # old ones garbage-collected
    assert not any(n.startswith("tmp-") for n in os.listdir(tmp_path))


def test_checkpoint_async(tmp_path):
    _, params, state, _, _, _ = _setup()
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(7, params, state, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_data_deterministic_and_resumable():
    dcfg = data_lib.DataConfig(vocab_size=100, seq_len=16, global_batch=4)
    a = data_lib.get_batch(dcfg, 42, device="cpu")
    b = data_lib.get_batch(dcfg, 42, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    c = data_lib.get_batch(dcfg, 43, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].max()) < 100


def test_lr_schedule():
    ocfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    assert float(opt.schedule(5, ocfg)) == pytest.approx(0.5, rel=0.01)
    assert float(opt.schedule(10, ocfg)) == pytest.approx(1.0, rel=0.01)
    assert float(opt.schedule(100, ocfg)) == pytest.approx(0.1, rel=0.01)


# ---------------------------------------------------------------------------
# the same data, schedule and int8 codes as the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frontend,dtype", [(None, "float32"), ("vit", "float32"),
                                            ("audio", "float32"), ("vit", "bfloat16"),
                                            ("audio", "bfloat16")])
def test_batches_bit_equal_to_reference(frontend, dtype):
    fields = dict(vocab_size=300, seq_len=24, global_batch=3, seed=4, frontend=frontend,
                  frontend_len=5 if frontend else 0, frontend_dim=12 if frontend else 0,
                  dtype=dtype)
    for step in range(5):
        want = jdata.get_batch(jdata.DataConfig(**fields), step)
        got = data_lib.get_batch(data_lib.DataConfig(**fields), step, device="cpu")
        assert got.keys() == want.keys()
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        for k in set(got) - {"tokens"}:
            assert got[k].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k]).astype(np.float32))


def test_schedule_equal_to_reference():
    """Steps 0-250: bit-equal through the warmup; after it, within lr x 2^-22
    absolute.  XLA's f32 cosine is a polynomial that misses the correctly
    rounded value by one ulp (2^-24 near 1) at some arguments, where torch's
    hits it (cos(0.8 pi) = -0.8090169944: XLA -0.80901706, torch
    -0.80901700); min_lr_frac + (1 - min_lr_frac) cos carries that ulp
    through, and near the end of the decay it is several ulps of the small
    result."""
    for fields in (dict(lr=3e-4), dict(lr=1.0, warmup_steps=10, decay_steps=100),
                   dict(lr=3e-3, warmup_steps=5, decay_steps=200, min_lr_frac=0.05)):
        cfg = opt.AdamWConfig(**fields)
        got = np.array([float(opt.schedule(s, cfg)) for s in range(251)], np.float32)
        want = np.array([float(jopt.schedule(jnp.array(s), jopt.AdamWConfig(**fields)))
                         for s in range(251)], np.float32)
        np.testing.assert_array_equal(got[:cfg.warmup_steps + 1], want[:cfg.warmup_steps + 1])
        np.testing.assert_allclose(got, want, rtol=0, atol=cfg.lr * 2.0 ** -22)


def test_int8_codes_bit_equal_to_reference():
    """The same f32 moments quantize to the same int8 codes and scales,
    rows of every rank, values on the .5 rounding ties included."""
    rng = np.random.default_rng(3)
    for shape in ((64, 256), (3, 4, 5), (17,)):
        x = (rng.standard_normal(shape) * 0.03).astype(np.float32)
        x.reshape(-1)[:4] = [0.5, -1.5, 2.5, 0.0]  # ties once scaled by a round scale
        want = jopt._q8(jnp.asarray(x))
        got = opt._q8(torch.from_numpy(x))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
        np.testing.assert_array_equal(opt._dq8(got, shape).numpy(),
                                      np.asarray(jopt._dq8(want, shape)))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def _npz(directory, step):
    with np.load(os.path.join(directory, f"step-{step:09d}", "state.npz")) as z:
        return {k: z[k] for k in z.files}


def _stepped_pair(moment_dtype):
    """Reference and port states after one reference step, bridged leaf for leaf."""
    cfg = j_reduced(j_get_config("smollm-135m"), n_layers=2, d_model=64, vocab_size=128)
    jmb = jbundle(cfg)
    ocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=200, moment_dtype=moment_dtype)
    jparams = jmb.init(jax.random.key(0))
    jstate = jopt.init(jparams, ocfg)
    batch = jdata.get_batch(jdata.DataConfig(vocab_size=128, seq_len=32, global_batch=8), 0)
    jparams, jstate, _ = jax.jit(j_make(jmb, ocfg, JTrainConfig(remat=False)))(
        jparams, jstate, batch)
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), _cfg(), device="cpu")
    tstate = opt.init(tparams, opt.AdamWConfig(moment_dtype=moment_dtype))
    return jparams, jstate, tparams, tstate


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_checkpoint_written_by_reference_restores_in_port(tmp_path, moment_dtype):
    jparams, jstate, tparams, tstate = _stepped_pair(moment_dtype)
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(3, jparams, jstate)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ref"))
    assert mgr.latest_step() == 3
    p, s = mgr.restore(3, tparams, tstate, device="cpu")
    assert int(s["step"]) == 1 and s["step"].dtype == torch.int32
    # written back by the port: the same keys and the same arrays
    ckpt.CheckpointManager(str(tmp_path / "port")).save(3, p, s)
    want, got = _npz(tmp_path / "ref", 3), _npz(tmp_path / "port", 3)
    assert got.keys() == want.keys()
    assert any(k.startswith("opt/m/groups/#0/") for k in got)
    if moment_dtype == "int8":
        assert any(k.endswith("/q") for k in got) and any(k.endswith("/scale") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_checkpoint_written_by_port_restores_in_reference(tmp_path, moment_dtype):
    jparams, jstate, tparams, _ = _stepped_pair(moment_dtype)
    mb = bundle(_cfg())
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=200, moment_dtype=moment_dtype)
    step_fn = make_train_step(mb, ocfg, TrainConfig(remat=False))
    batch = data_lib.get_batch(data_lib.DataConfig(vocab_size=128, seq_len=32, global_batch=8),
                               1, device="cpu")
    tparams, tstate, _ = step_fn(tparams, opt.init(tparams, ocfg), batch)
    ckpt.CheckpointManager(str(tmp_path)).save(9, tparams, tstate)
    mgr = jckpt.CheckpointManager(str(tmp_path))
    p, s = mgr.restore(9, jax.eval_shape(lambda: jparams), jax.eval_shape(lambda: jstate))
    flat = _npz(tmp_path, 9)
    n_leaves = len(jax.tree.leaves(p)) + len(jax.tree.leaves(s))
    assert len(flat) == n_leaves
    for path, leaf in jax.tree_util.tree_flatten_with_path({"params": p, "opt": s})[0]:
        key = "/".join(jckpt._path_str(q) for q in path)
        assert np.asarray(leaf).dtype == flat[key].dtype, key
        np.testing.assert_array_equal(np.asarray(leaf), flat[key], err_msg=key)
    want = {"params/" + k: v for k, v in ckpt._flatten(tparams).items()}
    want.update({"opt/" + k: v for k, v in ckpt._flatten(tstate).items()})
    assert want.keys() == flat.keys()


def test_bf16_leaves_keep_their_bits(tmp_path):
    """A bf16 leaf is written as the reference writes it (two raw bytes an
    element) and restores bit for bit."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32))
    params = {"w": x.to(torch.bfloat16), "b": x[0]}
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(0, params, {"step": torch.zeros((), dtype=torch.int32)})
    assert _npz(tmp_path, 0)["params/w"].dtype == np.dtype("V2")
    want = np.asarray(jnp.asarray(x.numpy(), jnp.bfloat16))
    assert _npz(tmp_path, 0)["params/w"].tobytes() == want.tobytes()
    p, _ = mgr.restore(0, params, {"step": torch.zeros((), dtype=torch.int32)})
    assert p["w"].dtype == torch.bfloat16 and torch.equal(p["w"], params["w"])


# ---------------------------------------------------------------------------
# the launcher twin
# ---------------------------------------------------------------------------
def _reference_train_small(monkeypatch):
    """examples/train_small.py on the reference's launcher, its host mesh
    given Auto axes (this JAX's default Explicit axes refuse the launcher's
    sharding constraints)."""
    import repro.launch.train as rtrain
    from jax.sharding import AxisType

    monkeypatch.setattr(rtrain, "make_host_mesh", lambda: jax.make_mesh(
        (len(jax.devices()),), ("data",), axis_types=(AxisType.Auto,)))
    spec = importlib.util.spec_from_file_location(
        "_reference_example_train_small", ROOT / "examples" / "train_small.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_STEP = re.compile(r"^step +(\d+) loss +([\d.]+) \(")
_FINAL = re.compile(r"^loss ([\d.]+) -> ([\d.]+) \((improved|NOT improved)\)$")


def _parsed(out):
    """The run's lines without their timing: ("step", n, loss), ("final",
    a, b, verdict) and every other line as it is, less the device or mesh."""
    lines = []
    for line in out.strip().splitlines():
        if m := _STEP.match(line):
            lines.append(("step", int(m.group(1)), float(m.group(2))))
        elif m := _FINAL.match(line):
            lines.append(("final", float(m.group(1)), float(m.group(2)), m.group(3)))
        else:
            lines.append(("line", line.split(" mesh=")[0].split(" device=")[0]))
    return lines


def _assert_same_lines(got, want):
    """Equal lines; losses are printed to 4 decimals from f32 losses that
    agree to ~1e-6, so a printed loss may sit one last digit off."""
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        if g[0] == "step":
            assert g[1] == w[1] and g[2] == pytest.approx(w[2], abs=2e-4)
        elif g[0] == "final":
            assert g[1:3] == pytest.approx(w[1:3], abs=2e-4) and g[3] == w[3]
        else:
            assert g == w


def test_train_small_prints_the_reference_examples_lines(tmp_path, monkeypatch, capsys):
    """Same weights (the reference's, bridged), same batches: the twin logs
    the example's lines, losses to the printed precision; a run stopped
    after 8 steps and relaunched resumes from its checkpoint and logs what
    the uninterrupted run logged."""
    ref = _reference_train_small(monkeypatch)
    kops.set_impl("ref")
    common = ["--steps", "12", "--log-every", "2", "--seed", "3"]

    def bridged(mb, seed, device):
        jp = jbundle(mb.cfg).init(jax.random.key(seed))
        return params_to_torch(jax.tree.map(np.asarray, jp), mb.cfg, device=device)

    monkeypatch.setattr(train_launch, "init_params", bridged)
    monkeypatch.setattr("sys.argv", ["train_small"] + common + ["--ckpt-dir",
                                                                str(tmp_path / "ref")])
    assert ref.main() == 0
    want = _parsed(capsys.readouterr().out)
    assert train_small.main(common + ["--device", "cpu", "--ckpt-dir",
                                      str(tmp_path / "port")]) == 0
    got = _parsed(capsys.readouterr().out)
    assert len(got) == 9 and got[0] == ("line", "arch=smollm-135m params=90,432")
    _assert_same_lines(got, want)

    resumed = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "resumed")]
    train_small.main(common + ["--steps", "8"] + resumed)
    first = [l for l in _parsed(capsys.readouterr().out) if l[0] == "step"]
    assert train_small.main(common + resumed) == 0
    second = _parsed(capsys.readouterr().out)
    assert second[1] == ("line", "resumed from step 7")
    # the same losses as the uninterrupted run, before and after the restart
    steps = [l for l in got if l[0] == "step"]
    assert [l[1] for l in first] == [0, 2, 4, 6, 7] and first[:4] == steps[:4]
    assert [l for l in second if l[0] == "step"] == steps[4:]
