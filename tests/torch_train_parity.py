"""Shared body of the training parity files (``test_torch_train_parity_*.py``):
for one architecture at ``reduced()`` size, f32, on the CPU, the reference
(``kops.set_impl("ref")``) and the port on the same bridged weights and the
same batches (both packages' ``get_batch``):

  * the loss and each metric (``ce``, ``aux``, ``mtp``): within 1e-5
    relative; every gradient leaf: max abs error / max abs of the leaf
    <= 1e-4;
  * three steps of ``make_train_step`` with f32 moments and block remat:
    every parameter within 1e-5;
  * three steps with int8 moments (no remat): the losses within 1e-5
    relative, every int8 code within one of the reference's, fewer than 1
    in 500 codes different, the scales within 1e-5 relative, and every
    parameter within 1e-5 outside the rows where a code differed.

The optimizer runs at lr 1e-3 and eps 1e-3, not the default eps of 1e-8:
Adam divides by sqrt(v), so a gradient element whose true value lies below
the two frameworks' f32 summation noise becomes a step of +-lr with a
random sign at eps 1e-8, and the packages end up to 2 lr apart per step
there; with eps 1e-3 such an element moves by about g / eps and the
comparison holds the arithmetic.  Under int8 moments
a moment whose scaled value sits within that noise of a .5 rounding tie
takes the next code in one package (a handful of codes per model), and
that code's row then moves by a different step: those rows are counted,
not compared to 1e-5, and from then on the two models differ in them, so
the later steps' scales are not compared.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs import get_config, reduced
from repro.kernels import ops as kops
from repro.models import bundle as jbundle, transformer as jtransformer
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_loop import TrainConfig as JTrainConfig, make_train_step as j_make
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.models import bundle as tbundle, transformer
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

LOSS_RTOL, GRAD_TOL, PARAM_ATOL, CODE_SHARE = 1e-5, 1e-4, 1e-5, 1 / 500
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, decay_steps=50)
STEPS = 3


def paths(tree, prefix="", sort=False):
    """{path: leaf}; ``sort`` walks dicts in sorted key order, as jax does."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        return {p: v for k in keys for p, v in paths(tree[k], f"{prefix}/{k}", sort).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in paths(x, f"{prefix}/{i}", sort).items()}
    return {prefix: tree}


def _by_row(a: np.ndarray) -> np.ndarray:
    """(rows, rest): the int8 moments' rows, one scale each (a 1-D leaf is one row)."""
    return a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(1, -1)


def _np(tree):
    return paths(jax.tree.map(np.asarray, tree), sort=True)


def _data(cfg, step):
    fields = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                  frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
                  frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim,
                  dtype=cfg.dtype)
    return (jdata.get_batch(jdata.DataConfig(**fields), step),
            tdata.get_batch(tdata.DataConfig(**fields), step, device="cpu"))


def run(name: str) -> dict:
    """Everything the parity files assert for ``name``; restores the
    reference's ``set_impl`` and both packages' ``set_remat``."""
    impl = (kops.get_impl(), kops._IMPL["interpret"])
    remat = (transformer.remat_mode(), jtransformer._REMAT["mode"])
    kops.set_impl("ref")
    try:
        return _run(name)
    finally:
        kops.set_impl(*impl)
        transformer.set_remat(remat[0])
        jtransformer.set_remat(remat[1])


def _run(name: str) -> dict:
    jmb = jbundle(reduced(get_config(name)))
    tmb = tbundle(t_reduced(t_get_config(name)))
    jp0 = jmb.init(jax.random.key(0))
    tp0 = params_to_torch(jax.tree.map(np.asarray, jp0), tmb.cfg, device="cpu")
    out = {"cfg": tmb.cfg}

    # loss, metrics and gradients on one batch
    jb, tb = _data(jmb.cfg, 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmb.loss_fn, has_aux=True))(jp0, jb)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp0)]
    tl, tm = tmb.loss_fn(tree_unflatten(tp0, leaves), tb)
    tg = torch.autograd.grad(tl, leaves)
    out["loss"] = (float(tl.detach()), float(jl))
    out["metrics"] = {k: (float(tm[k].detach()), float(jm[k])) for k in jm}
    out["metric_names"] = (sorted(tm), sorted(jm))
    jgd = _np(jg)
    tgd = paths(tree_unflatten(tp0, tg))
    assert tgd.keys() == jgd.keys()
    out["grads"] = {k: float(np.abs(tgd[k].numpy() - jgd[k]).max()
                             / max(float(np.abs(jgd[k]).max()), 1e-30)) for k in jgd}

    # three AdamW steps, f32 moments, block remat in both packages
    out["f32"] = _steps(jmb, tmb, jp0, tp0, "float32", remat=True)
    out["int8"] = _steps(jmb, tmb, jp0, tp0, "int8", remat=False)
    return out


def _steps(jmb, tmb, jp, tp, moment_dtype, remat):
    jcfg, tcfg = (jopt.AdamWConfig(**OPT, moment_dtype=moment_dtype),
                  topt.AdamWConfig(**OPT, moment_dtype=moment_dtype))
    jstep = jax.jit(j_make(jmb, jcfg, JTrainConfig(remat=remat)))
    tstep = make_train_step(tmb, tcfg, TrainConfig(remat=remat))
    js, ts = jopt.init(jp, jcfg), topt.init(tp, tcfg)
    losses, flipped, n_codes, n_diff, code_gap = [], {}, 0, 0, 0
    scale_err = {"m": 0.0, "v": 0.0}
    for i in range(STEPS):
        jb, tb = _data(jmb.cfg, i)
        jp, js, jmet = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        losses.append((float(tmet["loss"]), float(jmet["loss"])))
        if moment_dtype != "int8":
            continue
        jsd, tsd = _np(js), paths(ts)
        assert jsd.keys() == tsd.keys()
        for k in (k for k in jsd if k.endswith("/q")):  # /m/<leaf>/q, /v/<leaf>/q
            diff = tsd[k].numpy().astype(np.int32) - jsd[k].astype(np.int32)
            n_codes += diff.size
            n_diff += int((diff != 0).sum())
            code_gap = max(code_gap, int(np.abs(diff).max()))
            rows = flipped.setdefault("/" + k.split("/", 2)[2][:-len("/q")], set())
            rows.update(np.nonzero(_by_row(diff != 0).any(1))[0].tolist())
        for k in (k for k in jsd if k.endswith("/scale") and i == 0):
            # first step: m = (1 - b1) g and v = (1 - b2) g^2 from equal weights
            err = float(np.abs(tsd[k].numpy() - jsd[k]).max() / np.abs(jsd[k]).max())
            scale_err[k.split("/")[1]] = max(scale_err[k.split("/")[1]], err)
    jpd, tpd = _np(jp), paths(tp)
    assert jpd.keys() == tpd.keys()
    worst = 0.0
    for k in jpd:
        err = np.delete(_by_row(np.abs(tpd[k].float().numpy() - jpd[k].astype(np.float32))),
                        sorted(flipped.get(k, ())), axis=0)
        worst = max(worst, float(err.max()) if err.size else 0.0)
    return dict(losses=losses, param_err=worst, n_codes=n_codes, n_diff=n_diff,
                code_gap=code_gap, scale_err=scale_err,
                flipped_rows=sum(len(v) for v in flipped.values()))


def check(res: dict) -> None:
    """The assertions of the module docstring on ``run``'s result."""
    cfg = res["cfg"]
    want_names = {"ce", "aux"} | ({"mtp"} if cfg.mtp_depth else set())
    assert set(res["metric_names"][0]) == set(res["metric_names"][1]) == want_names
    got, want = res["loss"]
    assert abs(got - want) <= LOSS_RTOL * abs(want), res["loss"]
    for k, (g, w) in res["metrics"].items():
        assert abs(g - w) <= LOSS_RTOL * max(abs(w), 1e-30), (k, g, w)
    bad = {k: e for k, e in res["grads"].items() if e > GRAD_TOL}
    assert not bad, bad
    f32 = res["f32"]
    assert f32["param_err"] <= PARAM_ATOL, f32
    for g, w in f32["losses"]:
        assert abs(g - w) <= LOSS_RTOL * abs(w), f32["losses"]
    q8 = res["int8"]
    for g, w in q8["losses"]:
        assert abs(g - w) <= LOSS_RTOL * abs(w), q8["losses"]
    assert q8["n_codes"] > 0 and q8["code_gap"] <= 1, q8
    assert q8["n_diff"] <= CODE_SHARE * q8["n_codes"], q8
    assert q8["scale_err"]["m"] <= GRAD_TOL and q8["scale_err"]["v"] <= 2 * GRAD_TOL, q8
    assert q8["param_err"] <= PARAM_ATOL, q8
