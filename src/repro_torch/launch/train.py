"""End-to-end training entry point with fault tolerance.  Twin of
``repro/launch/train.py``, with its flags less ``--no-fsdp`` (one device,
no mesh) and with ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  Features:

  * auto-resume: restores the latest atomic checkpoint in ``--ckpt-dir`` if
    one exists -- restart after a failure is the fault-tolerance path (kill
    the process at any step; relaunching continues from the last
    checkpoint, which either package may have written);
  * asynchronous checkpoints every ``--ckpt-every`` steps, off the critical
    path (``--ckpt-blocking`` to write synchronously);
  * deterministic data: batch t is a pure function of (seed, t), so a
    resumed run consumes exactly the tokens a never-failed run would;
  * a NaN check on every step's loss, a log line every ``--log-every`` steps
    with tokens/s, and a last line ``loss a -> b (improved|NOT improved)``
    (the mean of the first and of the last tenth of the run's steps); the
    exit code is 0 when the loss improved, 1 when it did not.

On a CUDA device the forward pass runs the hand-written flash-attention and
SSD-scan kernels, each inside a ``torch.autograd.Function`` whose backward
is a plain PyTorch recompute.  Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \
      --steps 50 --batch 8 --seq 128 --device cpu --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 32 --seq 1024        # full config on the card
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def init_params(mb: ModelBundle, seed: int, device: torch.device):
    """The run's initial weights: ``mb.init`` from a generator seeded with
    ``seed``, drawn on the host so that a seed gives one set of weights on
    every device."""
    return mb.init(torch.Generator().manual_seed(seed), device=device)


def train(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the training loop; returns the steps run, their losses and host
    seconds (each step ends in a device sync: the loss is read), the first
    and last tenth's mean losses and whether the loss improved."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg, capacity_factor=8.0)
    dev = resolve_device(args.device)
    mb = bundle(cfg)
    print(f"arch={cfg.name} params={mb.param_count():,} device={dev}", flush=True)

    ocfg = opt.AdamWConfig(lr=args.lr)
    tcfg = TrainConfig(microbatch=args.microbatch, remat=True)
    step_fn = make_train_step(mb, ocfg, tcfg)
    dcfg = data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
        frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim, dtype=cfg.dtype,
    )

    params = init_params(mb, args.seed, dev)
    opt_state = opt.init(params, ocfg)
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            params, opt_state = ckpt.restore(latest, params, opt_state, device=dev)
            start = latest + 1
            print(f"resumed from step {latest}", flush=True)

    losses: List[float] = []
    seconds: List[float] = []
    t0 = time.time()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = data_mod.get_batch(dcfg, step, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        seconds.append(time.perf_counter() - ts)
        losses.append(loss)
        if np.isnan(loss):
            raise FloatingPointError(f"NaN loss at step {step}")
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tput = args.batch * args.seq * args.log_every / max(dt, 1e-9)
            print(f"step {step:5d} loss {loss:8.4f} ({dt:5.1f}s, {tput:,.0f} tok/s)", flush=True)
            t0 = time.time()
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, params, opt_state, blocking=args.ckpt_blocking)
    if ckpt is not None:
        ckpt.save(args.steps - 1, params, opt_state, blocking=True)
        ckpt.wait()
    first = float(np.mean(losses[: max(1, len(losses) // 10)]))
    last = float(np.mean(losses[-max(1, len(losses) // 10):]))
    improved = last < first
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if improved else 'NOT improved'})",
          flush=True)
    return dict(arch=cfg.name, start=start, losses=losses, step_seconds=seconds,
                first=first, last=last, improved=improved)


def main(argv: Optional[List[str]] = None) -> int:
    return 0 if train(parse_args(argv))["improved"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
