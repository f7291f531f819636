"""Shared body of the port's multi-rank tests (``test_torch_distributed*.py``,
``test_torch_moe_ep.py``, ``test_torch_pipeline.py``).

``spawn`` runs a function on N gloo ranks on the CPU, each a fresh
process, with a rendezvous file under the test's ``tmp_path`` (no fixed
port: the suite runs under xdist), one join deadline for all ranks and a
``destroy_process_group`` on every rank.  This module imports torch, numpy
and the port only, so a rank never imports JAX.

``reference`` runs a script of the reference package in a subprocess with
N forced host devices, as ``tests/test_distribution.py`` does; its meshes
take Auto axes (this JAX's default Explicit axes refuse the reference's
sharding constraints).

``sharded_case`` is the rank side of the train-step parity: for one mesh
case, the loss and gradients of batch 0 and (unless the case says
``"steps": False``) the parameters after two AdamW steps (f32 and int8
moments, or the case's ``"moments"``), gathered whole on rank 0; each case
spawns its own ranks, and ``unsharded_cases`` runs the same with no mesh in
a process beside them.
``REFERENCE_STEPS`` is the same on the reference's jitted sharded step
(one subprocess per case).  Both packages start from the
reference's initial weights (``params.pkl``), bridged into the port with
``bridge.params_to_torch``.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_TIMEOUT = 120
#: the optimizer of the train-parity files (tests/torch_train_parity.py)
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, decay_steps=50)
STEPS = 2
SEQ, BATCH = 16, 8
#: the AdamW moments a case steps with (a case's "moments" picks fewer)
MOMENTS = ("float32", "int8")


def _rank_main(rank, world, init, fn, args):
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, timeout: int = JOIN_TIMEOUT) -> None:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; raises if a rank
    fails or the ranks outlive ``timeout`` seconds together."""
    rdzv = Path(tempfile.mkdtemp(dir=tmp_path)) / "rendezvous"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, f"file://{rdzv}", fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        failed = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode not in (0, None)]
        assert not hung, f"ranks {hung} still running after {timeout} s"
        assert not failed, f"ranks failed (rank, exit code): {failed}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=tuple(names))


def _reference_env(n_dev: int) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    return env


def reference(n_dev: int, code: str, timeout: int = 300) -> str:
    """Run ``code`` on the reference with ``n_dev`` forced host devices."""
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, env=_reference_env(n_dev), timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def start_reference(n_dev: int, code: str, log: Path) -> subprocess.Popen:
    """``reference`` started in the background, its output in ``log``."""
    f = open(log, "w")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], stdout=f,
                            stderr=subprocess.STDOUT, env=_reference_env(n_dev))


def finish_reference(proc: subprocess.Popen, log: Path, timeout: int = 300) -> None:
    try:
        proc.wait(timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.read_text()[-3000:]


def paths(tree, prefix=""):
    """{path: leaf} over dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def full(x) -> np.ndarray:
    """A leaf gathered whole, as numpy."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def leaf_err(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| over the max |b| of the leaf."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _data_cfg(cfg, batch):
    from repro_torch.training import data as tdata

    return tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=batch,
                            frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
                            frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim,
                            dtype=cfg.dtype)


def port_cfg(arch: str, overrides: dict):
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(arch), **overrides)


def _run_case(mb, params, case, moe_impl):
    """Loss, gradients and 2-step parameters of one case, gathered whole;
    ``case["mesh"]`` None runs with no mesh."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distribution import sharding as shd
    from repro_torch.models import moe as moe_mod
    from repro_torch.training import data as tdata
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves, tree_unflatten

    moe_mod.set_moe_impl(moe_impl)
    m = mesh(*case["mesh"]) if case["mesh"] else None
    fsdp = case.get("fsdp", True)
    dcfg = _data_cfg(mb.cfg, case.get("batch", BATCH))
    ctx = shd.use_mesh(m, fsdp=fsdp) if m is not None else contextlib.nullcontext()
    place = (lambda t, s: shd.distribute(t, s, m)) if m is not None else (lambda t, s: t)
    shard = (lambda b: tdata.shard_batch(b, m)) if m is not None else (lambda b: b)
    out = {}
    with ctx:
        specs = shd.param_specs(params, m, fsdp) if m is not None else None
        p = place(params, specs)
        b0 = shard(tdata.get_batch(dcfg, 0, device="cpu"))
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        with implicit_replication() if m is not None else contextlib.nullcontext():
            loss, _ = mb.loss_fn(tree_unflatten(p, leaves), b0)
            grads = torch.autograd.grad(loss, leaves)
        out["loss"] = float(full(loss))
        out["grads"] = {k: full(v) for k, v in paths(tree_unflatten(p, grads)).items()}
        for moment in case.get("moments", MOMENTS) if case.get("steps", True) else ():
            ocfg = topt.AdamWConfig(**OPT, moment_dtype=moment)
            step = make_train_step(mb, ocfg, TrainConfig(remat=True,
                                                         microbatch=case.get("microbatch", 0)))
            st = topt.init(params, ocfg)
            st = place(st, shd.opt_state_specs(params, st, m, fsdp) if m is not None else None)
            pp, losses, codes = p, [], []
            for i in range(STEPS):
                pp, st, met = step(pp, st, shard(tdata.get_batch(dcfg, i, device="cpu")))
                losses.append(float(met["loss"]))
                codes.append({k: full(v) for k, v in paths(st).items() if k.endswith("/q")})
            out[moment] = {k: full(v) for k, v in paths(pp).items()}
            out[moment + "_losses"] = losses
            out[moment + "_codes"] = codes
    moe_mod.set_moe_impl("dispatch")
    return out


def _load(arch, overrides, out_dir):
    from repro_torch.bridge import params_to_torch
    from repro_torch.models import bundle

    cfg = port_cfg(arch, overrides)
    with open(Path(out_dir) / "params.pkl", "rb") as f:
        return bundle(cfg), params_to_torch(pickle.load(f), cfg, device="cpu")


def sharded_case(rank, world, out_dir, arch, overrides, name, case, moe_impl):
    """Rank body: one mesh case; rank 0 pickles its results."""
    mb, params = _load(arch, overrides, out_dir)
    out = _run_case(mb, params, case, moe_impl)
    if rank == 0:
        with open(Path(out_dir) / f"port-{name}.pkl", "wb") as f:
            pickle.dump(out, f)


def unsharded_cases(out_dir, arch, overrides, cases):
    """The same steps with no mesh and the port's dispatch, in a process of
    its own beside the ranks: the first case, and each microbatched one."""
    torch.set_num_threads(1)
    mb, params = _load(arch, overrides, out_dir)
    first = next(iter(cases))
    out = {name: _run_case(mb, params, dict(case, mesh=None), "dispatch")
           for name, case in cases.items() if case.get("microbatch") or name == first}
    with open(Path(out_dir) / "unsharded.pkl", "wb") as f:
        pickle.dump(out, f)


#: the reference's side of ``sharded_case``; format with opt_kw, arch,
#: overrides, out_dir, seq, batch, moe_impl, cases (a dict literal), steps
#: and name (the case this subprocess runs)
REFERENCE_STEPS = """
import pickle
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.kernels import ops as kops
from repro.models import bundle, moe as moe_mod
from repro.distribution import sharding as shd
from repro.training import data, optimizer as opt
from repro.training.train_loop import TrainConfig, make_train_step

kops.set_impl("ref")
OPT = {opt_kw}
cfg = reduced(get_config({arch!r}), **{overrides!r})
mb = bundle(cfg)
with open({out_dir!r} + "/params.pkl", "rb") as f:
    params = jax.tree.map(jax.numpy.asarray, pickle.load(f))

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {{p: v for k in tree for p, v in paths(tree[k], f"{{prefix}}/{{k}}").items()}}
    if isinstance(tree, (list, tuple)):
        return {{p: v for i, x in enumerate(tree) for p, v in paths(x, f"{{prefix}}/{{i}}").items()}}
    return {{prefix: tree}}

def dcfg(batch):
    return data.DataConfig(vocab_size=cfg.vocab_size, seq_len={seq}, global_batch=batch,
                           frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
                           frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim,
                           dtype=cfg.dtype)

moe_mod.set_moe_impl({moe_impl!r})
results = {{}}
NAME = {name!r}
for name, case in {cases!r}.items():
    if name != NAME:
        continue
    shape, names = case["mesh"]
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    fsdp = case.get("fsdp", True)
    dc = dcfg(case.get("batch", {batch}))
    out = {{}}
    with shd.use_mesh(mesh, fsdp=fsdp):
        pn = shd.named(shd.param_specs(params, mesh, fsdp), mesh)
        p = jax.tree.map(jax.device_put, params, pn)
        b0 = data.shard_batch(data.get_batch(dc, 0), mesh)
        (loss, _), grads = jax.jit(jax.value_and_grad(mb.loss_fn, has_aux=True))(p, b0)
        out["loss"] = float(loss)
        out["grads"] = {{k: np.asarray(v) for k, v in paths(grads).items()}}
        for moment in case.get("moments", ("float32", "int8")) if case.get("steps", True) else ():
            ocfg = opt.AdamWConfig(**OPT, moment_dtype=moment)
            st = opt.init(params, ocfg)
            on = shd.named(shd.opt_state_specs(params, st, mesh, fsdp), mesh)
            st = jax.tree.map(jax.device_put, st, on)
            step = jax.jit(make_train_step(mb, ocfg, TrainConfig(
                remat=True, microbatch=case.get("microbatch", 0))),
                in_shardings=(pn, on, None), out_shardings=(pn, on, None))
            pp, losses, codes = p, [], []
            for i in range({steps}):
                pp, st, met = step(pp, st, data.shard_batch(data.get_batch(dc, i), mesh))
                losses.append(float(met["loss"]))
                codes.append({{k: np.asarray(v).astype(np.float32)
                              for k, v in paths(st).items() if k.endswith("/q")}})
            out[moment] = {{k: np.asarray(v) for k, v in paths(pp).items()}}
            out[moment + "_losses"] = losses
            out[moment + "_codes"] = codes
    results[name] = out
with open({out_dir!r} + f"/ref-{{NAME}}.pkl", "wb") as f:
    pickle.dump(results, f)
print("OK")
"""


def init_reference_params(arch: str, overrides: dict, out_dir: Path) -> None:
    """The reference's initial weights for ``arch`` (key 0), pickled as numpy
    into ``out_dir/params.pkl`` for both packages."""
    import jax

    from repro.configs import get_config, reduced
    from repro.models import bundle

    params = bundle(reduced(get_config(arch), **overrides)).init(jax.random.key(0))
    with open(out_dir / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)


def run_parity(tmp_path, arch, cases, overrides=None, moe_impl="dispatch", world=4):
    """The reference's sharded steps (one subprocess per case, in parallel)
    and the port's on ``world`` gloo ranks, all from the same initial
    weights; returns (reference results, port results) by case name."""
    overrides = overrides or {}
    out_dir = Path(tmp_path)
    init_reference_params(arch, overrides, out_dir)
    procs = []
    for name in cases:
        code = REFERENCE_STEPS.format(
            opt_kw=repr(OPT), arch=arch, overrides=overrides, out_dir=str(out_dir), seq=SEQ,
            batch=BATCH, moe_impl=moe_impl, cases=cases, steps=STEPS, name=name)
        log = out_dir / f"ref-{name}.log"
        procs.append((start_reference(world, code, log), log))
    plain = mp.get_context("spawn").Process(target=unsharded_cases,
                                            args=(str(out_dir), arch, overrides, cases))
    plain.start()
    try:
        for name, case in cases.items():
            spawn(sharded_case, world, tmp_path, str(out_dir), arch, overrides, name, case,
                  moe_impl)
    finally:
        plain.join(JOIN_TIMEOUT)
        if plain.is_alive():
            plain.kill()
            plain.join()
        for proc, log in procs:
            finish_reference(proc, log)
    assert plain.exitcode == 0, f"the unsharded run exited {plain.exitcode}"
    ref, port = {}, {}
    for name in cases:
        with open(out_dir / f"ref-{name}.pkl", "rb") as f:
            ref.update(pickle.load(f))
        with open(out_dir / f"port-{name}.pkl", "rb") as f:
            port[name] = pickle.load(f)
    with open(out_dir / "unsharded.pkl", "rb") as f:
        port["unsharded"] = pickle.load(f)
    return ref, port


def _rows(a: np.ndarray) -> np.ndarray:
    return a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(1, -1)


def check_int8(got: dict, want: dict, tol: float, code_share: float = 1 / 500) -> None:
    """Two int8-moment runs agree as the parity files hold them
    (tests/torch_train_parity.py): every code within one of the other's,
    fewer than ``code_share`` of them different at any step, and every
    parameter within ``tol`` of its leaf's max outside the rows where a
    code differed at some step (a moment within summation noise of a
    rounding tie takes the next code in one run, and its row then takes a
    different step)."""
    flipped: dict = {}
    for gc, wc in zip(got["int8_codes"], want["int8_codes"]):
        assert gc.keys() == wc.keys()
        n = d = 0
        for k in wc:
            diff = gc[k].astype(np.int32) - wc[k].astype(np.int32)
            assert np.abs(diff).max() <= 1, k
            n, d = n + diff.size, d + int((diff != 0).sum())
            leaf = k[len("/m"):-len("/q")] if k.startswith("/m/") else k[len("/v"):-len("/q")]
            flipped.setdefault(leaf, set()).update(np.nonzero(_rows(diff != 0).any(1))[0].tolist())
        assert d < code_share * n, (d, n)
    gp, wp = got["int8"], want["int8"]
    assert gp.keys() == wp.keys()
    for k in wp:
        keep = np.ones(_rows(wp[k]).shape[0], bool)
        keep[sorted(flipped.get(k, ()))] = False
        a, b = _rows(gp[k])[keep], _rows(wp[k])[keep]
        if a.size:
            assert np.abs(a - b).max() <= tol * max(float(np.abs(wp[k]).max()), 1e-30), k


LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4


def _baselines(ref, port, name):
    """The reference's sharded run and the port's unsharded run of case
    ``name`` (the unsharded run of a case without microbatches is shared)."""
    un = port["unsharded"]
    return ref[name], (un[name] if name in un else next(iter(un.values())))


def check_loss(ref, port, name):
    got = port[name]["loss"]
    for want in _baselines(ref, port, name):
        assert abs(got - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (got, want["loss"])


def check_grads(ref, port, name):
    got = port[name]["grads"]
    for want in _baselines(ref, port, name):
        assert got.keys() == want["grads"].keys()
        errs = {k: leaf_err(got[k], want["grads"][k]) for k in got}
        assert max(errs.values()) <= LEAF_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def check_params(ref, port, name, moment):
    for want in _baselines(ref, port, name):
        if moment == "int8":
            check_int8(port[name], want, LEAF_TOL)
        else:
            got = port[name][moment]
            assert got.keys() == want[moment].keys()
            errs = {k: leaf_err(got[k], want[moment][k]) for k in got}
            assert max(errs.values()) <= LEAF_TOL, sorted(errs.items(),
                                                          key=lambda kv: -kv[1])[:3]
        np.testing.assert_allclose(port[name][moment + "_losses"], want[moment + "_losses"],
                                   rtol=LOSS_RTOL)


def sharded_decode_case(rank, world, out_dir, archs=("smollm-135m",)):
    """For each of ``archs`` at ``reduced()``, f32: a prefill of 16 tokens
    and two decode steps on a (2, 2) mesh, parameters placed without fsdp
    and the cache by ``cache_specs`` (a KV cache's sequence over ``model``,
    so every write lands in each rank's block of rows, and the decode kernel
    takes it through ``local_map``; a recurrent state by batch and its
    widest dim); rank 0 also runs the same with no mesh and saves the logits
    and every leaf of the final cache of both (``<arch>-sharded.npz``,
    ``<arch>-plain.npz``)."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distribution import sharding as shd
    from repro_torch.models import bundle

    def run(mb, params, prompt, steps, m):
        out = {}
        if m is None:
            p, place = params, (lambda t, s: t)
        else:
            p = shd.distribute(params, shd.param_specs(params, m, False), m)
            place = (lambda t, s: shd.distribute(t, s, m))
        ctx = shd.use_mesh(m, fsdp=False) if m is not None else contextlib.nullcontext()
        rep = implicit_replication() if m is not None else contextlib.nullcontext()
        with ctx, rep:
            batch = {"tokens": place(prompt, (shd.data_axes(m)[0] if m is not None else None,
                                              None))}
            logits, cache = mb.prefill_fn(p, batch, max_len=32)
            out["prefill"] = full(logits)
            for i in range(2):
                tok = place(steps[i], ("data", None) if m is not None else None)
                idx = place(torch.tensor(16 + i, dtype=torch.int32), ())
                logits, cache = mb.decode_fn(p, cache, tok, idx)
                out[f"decode{i}"] = full(logits)
            for k, v in paths(cache).items():
                if not k.endswith("/index"):
                    out[k] = full(v)
        return out

    for arch in archs:
        cfg = port_cfg(arch, {})
        mb = bundle(cfg)
        params = mb.init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).to(torch.int32)
        steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4, 1))).to(torch.int32)
        sharded = run(mb, params, prompt, steps, mesh((2, 2), ("data", "model")))
        if rank == 0:
            np.savez(Path(out_dir) / f"{arch}-sharded.npz", **sharded)
            np.savez(Path(out_dir) / f"{arch}-plain.npz", **run(mb, params, prompt, steps, None))
