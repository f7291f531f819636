"""Serving entry point: one continuous-batching engine fed by a seeded synthetic
request stream, or a cluster of replicas placed by the paper's placement
engine.  Counterpart of ``repro/launch/serve.py``.

Engine mode (one replica, real forward passes):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Cluster mode (placement only, no engine runs: the reference's model mix,
counts and verbs on ``CLUSTER_DEVICE`` nodes, the H100 80GB's MIG geometry):
  PYTHONPATH=src python -m repro_torch.launch.serve --cluster --nodes 4 \
      --policy heuristic

An int8 KV cache is switched on through ``models.layers.set_kv_quant(True)``
before ``main`` / ``run_engine``, as in the reference (no CLI switch).

Weights are random, drawn from a ``torch.Generator`` seeded with ``--seed``.
Prompt lengths are drawn from ``[--prompt-len LO HI)`` (default
``[4, max_len // 4)``) and ``max_new_tokens`` from ``[--min-new, --max-new)``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.profiles import H100_80GB
from repro_torch.device import resolve_device
from repro_torch.models import bundle
from repro_torch.serving import ClusterServer, Engine, EngineConfig, Request

#: the device model of every node in cluster mode
CLUSTER_DEVICE = H100_80GB


def make_requests(args, vocab_size: int) -> List[Request]:
    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_len or (4, args.max_len // 4)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(lo, hi))
        prompt = list(map(int, rng.integers(1, vocab_size, size=plen)))
        reqs.append(Request(rid=f"req{i}", prompt=prompt,
                            max_new_tokens=int(rng.integers(args.min_new, args.max_new))))
    return reqs


def run_engine(args) -> Dict[str, Any]:
    """Build the model and engine on ``args.device``, serve the request
    stream to completion and return what happened."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    mb = bundle(cfg)
    params = mb.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    eng = Engine(mb, params, EngineConfig(max_slots=args.slots, max_len=args.max_len))
    for req in make_requests(args, cfg.vocab_size):
        eng.submit(req)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in done)
    if len(done) != args.requests:
        raise RuntimeError(f"{len(done)} of {args.requests} requests completed")
    return {"completions": done, "tokens": toks, "seconds": dt, "tok_per_s": toks / dt,
            "stats": dict(eng.stats), "engine": eng, "params": params, "bundle": mb}


def run_cluster(args) -> int:
    srv = ClusterServer(n_nodes=args.nodes, device=CLUSTER_DEVICE, policy=args.policy)
    print(f"cluster: {args.nodes} nodes of {CLUSTER_DEVICE.name}, policy={args.policy}")
    # Scale-up wave (paper: initial deployment)
    for model, arch, n in (
        ("chat", "smollm-135m", 5),
        ("code", "chatglm3-6b", 3),
        ("draft", "xlstm-125m", 2),
    ):
        rep = srv.deploy(model, arch, n, max_batch=8, max_len=4096)
        print(f"  deploy {model} ({arch}) x{n}: placed={len(rep.placed)} "
              f"pending={len(rep.pending)} nodes_used={rep.metrics.n_gpus}")
    print(f"  utilization: {srv.utilization()}")
    # Scale-down + compaction (paper Sec 2.3.2)
    srv.retire("chat", 3)
    srv.retire("code", 1)
    rep = srv.compact()
    print(f"  compaction: {rep.before.n_gpus} -> {rep.after.n_gpus} nodes, "
          f"{rep.plan.n_moves} moves ({rep.plan.n_sequential} sequential)")
    # Maintenance reconfiguration (paper Sec 2.3.3)
    rep = srv.reconfigure()
    print(f"  reconfiguration: {rep.before.n_gpus} -> {rep.after.n_gpus} nodes, "
          f"wastage {rep.before.compute_wastage} -> {rep.after.compute_wastage}")
    print(f"  final: {srv.utilization()}")
    srv.state.validate()
    return 0


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, nargs=2, metavar=("LO", "HI"), default=None)
    ap.add_argument("--min-new", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--policy", default="heuristic",
                    choices=["heuristic", "mip", "first_fit", "load_balanced"])
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.cluster:
        return run_cluster(args)
    res = run_engine(args)
    st = res["stats"]
    print(f"{len(res['completions'])} completions, {res['tokens']} tokens in "
          f"{res['seconds']:.2f}s ({res['tok_per_s']:,.1f} tok/s), "
          f"{st['decode_steps']} decode steps, {st['prefills']} prefills")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
