"""End-to-end training entry point with fault tolerance.  Twin of
``repro/launch/train.py``, with its flags, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels) and
``--dist-init`` (the process group's init method under a launcher, default
``env://``).  Features:

  * ranks: launched by ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the
    environment) it joins that process group, NCCL on ``cuda`` and gloo on
    ``cpu``; alone it makes a one-rank group.  The mesh is
    ``make_host_mesh()``, a 1-D ``data`` mesh over the ranks; parameters and
    optimizer state are placed by the sharding rules (fsdp unless
    ``--no-fsdp``), each step's batch by ``shard_batch``, and only rank 0
    prints.  On one rank everything stays a plain tensor;
  * elastic resume: a checkpoint saved on N ranks restores onto this run's
    mesh of M;

  * auto-resume: restores the latest atomic checkpoint in ``--ckpt-dir`` if
    one exists -- restart after a failure is the fault-tolerance path (kill
    the process at any step; relaunching continues from the last
    checkpoint, which either package may have written);
  * asynchronous checkpoints every ``--ckpt-every`` steps, off the critical
    path (``--ckpt-blocking`` to write synchronously);
  * deterministic data: batch t is a pure function of (seed, t), so a
    resumed run consumes exactly the tokens a never-failed run would;
  * ``--report PATH``: rank 0 writes the run's losses, step seconds and
    the kernels' launch counts (this process's, from its start) as JSON;
  * a NaN check on every step's loss, a log line every ``--log-every`` steps
    with tokens/s, and a last line ``loss a -> b (improved|NOT improved)``
    (the mean of the first and of the last tenth of the run's steps); the
    exit code is 0 when the loss improved, 1 when it did not.

On a CUDA device the forward pass runs the hand-written flash-attention and
SSD-scan kernels, each inside a ``torch.autograd.Function`` whose backward
is a plain PyTorch recompute; under a mesh each rank runs them on its own
rows and heads.  Weights are random, drawn from a ``torch.Generator``
seeded with ``--seed``, the same on every rank.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \
      --steps 50 --batch 8 --seq 128 --device cpu --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 32 --seq 1024        # full config on the card
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --reduced --device cpu   # two gloo ranks
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.distribution import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import bundle
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import TrainConfig, make_train_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="tiny config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-blocking", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist-init", default="env://",
                    help="init method of the process group under a launcher")
    ap.add_argument("--report", default="",
                    help="rank 0 writes the run's losses, step seconds and kernel launch "
                         "counts to this JSON file")
    return ap.parse_args(argv)


def init_ranks(device: torch.device, init_method: str = "env://") -> bool:
    """Join the launcher's process group (``RANK`` / ``WORLD_SIZE`` in the
    environment; NCCL on cuda, each rank on its ``LOCAL_RANK``'s card; gloo
    on the CPU), or make a one-rank group.  Returns whether this call made
    the group (and should destroy it); an existing group is kept."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def init_params(mb: ModelBundle, seed: int, device: torch.device):
    """The run's initial weights: ``mb.init`` from a generator seeded with
    ``seed``, drawn on the host so that a seed gives one set of weights on
    every device."""
    return mb.init(torch.Generator().manual_seed(seed), device=device)


def train(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the training loop; returns the steps run, their losses and host
    seconds (each step ends in a device sync: the loss is read), the first
    and last tenth's mean losses and whether the loss improved."""
    made = init_ranks(resolve_device(args.device), args.dist_init)
    try:
        return _train(args)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> Dict[str, Any]:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg, capacity_factor=8.0)
    dev = resolve_device(args.device)
    mb = bundle(cfg)
    mesh = make_host_mesh(dev.type)
    fsdp = not args.no_fsdp
    lead = dist.get_rank() == 0

    def say(line: str) -> None:
        if lead:
            print(line, flush=True)

    say(f"arch={cfg.name} params={mb.param_count():,} device={dev} "
        f"mesh={dict(shd.mesh_axes(mesh))}")

    ocfg = opt.AdamWConfig(lr=args.lr)
    tcfg = TrainConfig(microbatch=args.microbatch, remat=True)
    step_fn = make_train_step(mb, ocfg, tcfg)
    dcfg = data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
        frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim, dtype=cfg.dtype,
    )

    with shd.use_mesh(mesh, fsdp=fsdp):
        params = init_params(mb, args.seed, dev)
        opt_state = opt.init(params, ocfg)
        pspecs = shd.param_specs(params, mesh, fsdp)
        ospecs = shd.opt_state_specs(params, opt_state, mesh, fsdp)
        params = shd.distribute(params, pspecs, mesh)
        opt_state = shd.distribute(opt_state, ospecs, mesh)
        start = 0
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        if ckpt is not None:
            latest = ckpt.latest_step()
            if latest is not None:
                params, opt_state = ckpt.restore(latest, params, opt_state, device=dev,
                                                 shardings=(pspecs, ospecs))
                start = latest + 1
                say(f"resumed from step {latest}")

        losses: List[float] = []
        seconds: List[float] = []
        t0 = time.time()
        for step in range(start, args.steps):
            ts = time.perf_counter()
            batch = data_mod.shard_batch(data_mod.get_batch(dcfg, step, device=dev), mesh)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            seconds.append(time.perf_counter() - ts)
            losses.append(loss)
            if np.isnan(loss):
                raise FloatingPointError(f"NaN loss at step {step}")
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                tput = args.batch * args.seq * args.log_every / max(dt, 1e-9)
                say(f"step {step:5d} loss {loss:8.4f} ({dt:5.1f}s, {tput:,.0f} tok/s)")
                t0 = time.time()
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step, params, opt_state, blocking=args.ckpt_blocking)
        if ckpt is not None:
            ckpt.save(args.steps - 1, params, opt_state, blocking=True)
            ckpt.wait()
    first = float(np.mean(losses[: max(1, len(losses) // 10)]))
    last = float(np.mean(losses[-max(1, len(losses) // 10):]))
    improved = last < first
    say(f"loss {first:.4f} -> {last:.4f} ({'improved' if improved else 'NOT improved'})")
    out = dict(arch=cfg.name, start=start, losses=losses, step_seconds=seconds,
               first=first, last=last, improved=improved, world=dist.get_world_size())
    if args.report and lead:
        with open(args.report, "w") as f:
            json.dump(dict(out, launches=ops.launch_counts()), f)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    return 0 if train(parse_args(argv))["improved"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
