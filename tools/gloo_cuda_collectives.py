"""Which collectives gloo carries for CUDA tensors, with ranks sharing one card.

One H100 cannot hold an NCCL communicator of two ranks on the same device,
so ranks that share the card talk over gloo.  The sharded train step runs
through DTensor, which calls the functional collectives
(``torch.distributed._functional_collectives``: ``all_reduce``,
``all_gather_tensor``, ``reduce_scatter_tensor``, ``all_to_all_single``,
each ended by ``wait_tensor``).  This script starts 4 ranks on ``cuda:0``
over gloo once per collective, each probe in fresh processes so that a
crash is attributed to the collective that caused it, and reports for each
whether every rank finished with the right values.  It probes the c10d
calls (``torch.distributed.all_reduce`` and the rest, synchronous and
``async_op=True``) and the functional ones, then a DTensor
``Shard -> Replicate`` redistribution on a 2 x 2 mesh.

  python3 tools/gloo_cuda_collectives.py [--device cuda|cpu] [--ranks 4]

Prints the card's name and power limit (nvidia-smi), one line per probe
and one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

PROBES = [
    "c10d.all_reduce", "c10d.broadcast", "c10d.all_gather_into_tensor",
    "c10d.all_gather_into_tensor.async", "c10d.reduce_scatter_tensor",
    "c10d.reduce_scatter_tensor.async", "c10d.all_to_all_single",
    "c10d.all_to_all_single.async", "functional.all_reduce", "functional.all_gather_tensor",
    "functional.reduce_scatter_tensor", "functional.all_to_all_single",
    "dtensor.shard_to_replicate",
]


def _probe(rank: int, world: int, init: str, name: str, device: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
        x = torch.arange(2 * world, dtype=torch.float32, device=dev) + 100 * rank
        total = sum(torch.arange(2 * world, dtype=torch.float32) + 100 * r for r in range(world))
        g = dist.group.WORLD
        kind, op = name.split(".", 1)
        if kind == "dtensor":
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import Replicate, Shard, distribute_tensor

            mesh = DeviceMesh(device, torch.arange(world).reshape(2, world // 2),
                              mesh_dim_names=("data", "model"))
            t = torch.arange(16.0, device=dev).reshape(4, 4)
            got = distribute_tensor(t, mesh, (Shard(0), Shard(1)), src_data_rank=None)
            got = got.redistribute(mesh, (Replicate(), Replicate())).to_local()
            want = t
        elif op.startswith("all_reduce"):
            got = x.clone()
            if kind == "c10d":
                dist.all_reduce(got)
            else:
                got = fc.wait_tensor(fc.all_reduce(x, "sum", g))
            want = total
        elif op.startswith("broadcast"):
            got = x.clone()
            dist.broadcast(got, 0)
            want = torch.arange(2 * world, dtype=torch.float32)
        elif op.startswith("all_gather"):
            if kind == "c10d":
                got = torch.empty(2 * world * world, device=dev)
                work = dist.all_gather_into_tensor(got, x, async_op=op.endswith("async"))
                if work is not None:
                    work.wait()
            else:
                got = fc.wait_tensor(fc.all_gather_tensor(x, 0, g))
            want = torch.cat([torch.arange(2 * world, dtype=torch.float32) + 100 * r
                              for r in range(world)])
        elif op.startswith("reduce_scatter"):
            if kind == "c10d":
                got = torch.empty(2, device=dev)
                work = dist.reduce_scatter_tensor(got, x, async_op=op.endswith("async"))
                if work is not None:
                    work.wait()
            else:
                got = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, g))
            want = total[2 * rank: 2 * rank + 2]
        else:  # all_to_all_single
            if kind == "c10d":
                got = torch.empty_like(x)
                work = dist.all_to_all_single(got, x, async_op=op.endswith("async"))
                if work is not None:
                    work.wait()
            else:
                got = fc.wait_tensor(fc.all_to_all_single(x, None, None, g))
            want = torch.cat([torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32)
                              + 100 * r for r in range(world)])
        if device == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            raise SystemExit(3)
    finally:
        dist.destroy_process_group()


def run_probe(name: str, device: str, world: int, timeout: float = 120.0) -> dict:
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{os.path.join(d, 'rendezvous')}"
        procs = [ctx.Process(target=_probe, args=(r, world, init, name, device))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
    ok = not hung and all(c == 0 for c in codes)
    return dict(probe=name, ok=ok, exit_codes=codes, hung=hung,
                seconds=round(time.perf_counter() - t0, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("gloo_cuda_collectives: no CUDA device", file=sys.stderr)
        return 1
    if args.device == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    results = []
    for name in PROBES:
        r = run_probe(name, args.device, args.ranks)
        print(f"{name}: {'ok' if r['ok'] else 'FAILED'} exit codes {r['exit_codes']}",
              flush=True)
        results.append(r)
    print(json.dumps({"torch": torch.__version__, "device": args.device, "ranks": args.ranks,
                      "probes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
