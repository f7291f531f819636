"""Multi-pod dry-run: run every (architecture x input shape x mesh) cell's
sharded step on the production meshes and count one rank's roofline terms.
Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 fake host devices and reads the terms from the compiled HLO.

Here each cell runs the port's own step -- ``make_train_step`` (train),
``prefill_fn`` (prefill) or ``decode_fn`` (decode) -- on ``meta`` tensors,
distributed over a fake process group of 256 (or 512) ranks
(``torch.testing._internal.distributed.fake_pg``) on the mesh of
``make_production_mesh`` (device type ``"cuda"``: a ``"cpu"`` mesh swaps
all-to-alls for all-gathers).  ``distribution.cost_analysis.CostCounter``
counts rank 0's FLOPs, HBM bytes, collective bytes and memory op by op, and
each kernel books its launch by its own cost (``kernels.cost``).  The
roofline terms are taken against the H100's datasheet peaks below.

The tensors live on ``meta``: the dry-run runs nothing on a card, just as
the reference's runs on fake host devices and not on the TPU.  That is why
it is the one entry point that does not default to ``cuda``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh both
Artifacts: artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..distribution import sharding as shd
from ..distribution.cost_analysis import CostCounter, local_bytes
from .mesh import make_production_mesh
from ..models import layers, transformer
from ..models import moe as moe_mod
from ..models.model_zoo import bundle
from ..training import optimizer as opt
from ..training.train_loop import TrainConfig, make_train_step

__all__ = ["TRAIN_POLICY", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "build_cell", "model_flops",
           "run_cell", "main"]

# ---------------------------------------------------------------------------
# per-arch training memory policy (the reference's)
# ---------------------------------------------------------------------------
_DEFAULT_POLICY = dict(moment_dtype="float32", accum_dtype="float32", microbatch=16)
TRAIN_POLICY: Dict[str, Dict[str, Any]] = {
    "mistral-large-123b": dict(moment_dtype="bfloat16", accum_dtype="bfloat16", microbatch=16),
    "nemotron-4-340b": dict(moment_dtype="int8", accum_dtype="bfloat16", microbatch=16),
    "deepseek-v3-671b": dict(moment_dtype="int8", accum_dtype="bfloat16", microbatch=16),
    "mixtral-8x7b": dict(moment_dtype="bfloat16", accum_dtype="bfloat16", microbatch=16),
    "pixtral-12b": dict(moment_dtype="float32", accum_dtype="bfloat16", microbatch=16),
}

#: NVIDIA H100 SXM5 80GB datasheet, 700 W (the card chip_smoke.py runs on,
#: "NVIDIA H100 80GB HBM3, 700.00 W"): dense bf16 tensor-core FLOP/s per GPU
PEAK_FLOPS = 989e12
#: HBM3 bytes/s per GPU, same datasheet
HBM_BW = 3.35e12
#: bytes/s per GPU off the node: one 400 Gb/s NDR InfiniBand NIC per GPU.
#: Every axis of (16, 16) and (2, 16, 16) spans more than one 8-GPU NVLink
#: domain, so the NIC bounds each ring (NVLink 4 gives 450 GB/s each way
#: inside a node)
LINK_BW = 50e9

_SKIP_REASON = "full-attention arch; long_500k needs sub-quadratic decode (DESIGN.md)"
_MESHES = {False: "pod16x16", True: "pod2x16x16"}


def _policy(arch: str) -> Dict[str, Any]:
    return {**_DEFAULT_POLICY, **TRAIN_POLICY.get(arch, {})}


def build_cell(arch: str, shape_name: str, mesh, *, sp: bool, fsdp: bool,
               moe_impl: str = "dispatch", cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None):
    """Returns (step, args): ``step(*args)`` runs the cell's step on ``meta``
    tensors distributed over ``mesh`` (each leaf as the sharding rules place
    it).  The caller enters ``use_mesh`` and the MoE switch; train steps set
    remat process-wide (``make_train_step``), which the caller restores."""
    cfg = cfg or get_config(arch)
    mb = bundle(cfg)
    shape = shape or SHAPES[shape_name]
    pol = _policy(arch)
    moe_mod.set_moe_impl(moe_impl)
    params_s = mb.param_shapes()
    params = shd.distribute(params_s, shd.param_specs(params_s, mesh, fsdp), mesh)

    if shape.kind == "train":
        ocfg = opt.AdamWConfig(moment_dtype=pol["moment_dtype"])
        opt_s = opt.init(params_s, ocfg)
        opt_state = shd.distribute(opt_s, shd.opt_state_specs(params_s, opt_s, mesh, fsdp), mesh)
        tcfg = TrainConfig(microbatch=pol["microbatch"], remat=True,
                           accum_dtype=pol["accum_dtype"])
        batch_s = mb.input_specs(shape)["batch"]
        batch = shd.distribute(batch_s, shd.batch_specs(batch_s, mesh), mesh)
        return make_train_step(mb, ocfg, tcfg), (params, opt_state, batch)

    if shape.kind == "prefill":
        batch_s = mb.input_specs(shape)["batch"]
        batch = shd.distribute(batch_s, shd.batch_specs(batch_s, mesh), mesh)

        def prefill(params, b):
            return mb.prefill_fn(params, b, max_len=shape.seq_len)

        return prefill, (params, batch)

    # decode
    specs = mb.input_specs(shape)
    cache = shd.distribute_cache(specs["cache"], mesh, shape.global_batch)
    tokens = shd.distribute(specs["tokens"], shd.batch_specs(specs["tokens"], mesh), mesh)
    index = shd.distribute(specs["index"], (), mesh)
    return mb.decode_fn, (params, cache, tokens, index)


def model_flops(arch: str, shape_name: str, cfg: Optional[ArchConfig] = None,
                shape: Optional[ShapeConfig] = None) -> float:
    """Analytic useful-FLOPs for the cell (6·N_active·tokens train,
    2·N_active·tokens inference)."""
    mb = bundle(cfg or get_config(arch))
    n_active = mb.active_param_count()
    shape = shape or SHAPES[shape_name]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token per sequence


@contextlib.contextmanager
def _process_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0) when
    none exists; an existing group is used as it is and left alone."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape: Optional[Tuple[Sequence[int], Sequence[str]]]):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    from torch.distributed.device_mesh import init_device_mesh

    dims, names = mesh_shape
    return init_device_mesh("cuda", tuple(dims), mesh_dim_names=tuple(names))


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, sp: bool = False,
             fsdp: bool = True, moe_impl: str = "alltoall", kv_quant: bool = False,
             out_dir: Optional[str] = "artifacts/dryrun_torch", tag: str = "",
             cfg: Optional[ArchConfig] = None, shape: Optional[ShapeConfig] = None,
             mesh_shape: Optional[Tuple[Sequence[int], Sequence[str]]] = None
             ) -> Dict[str, Any]:
    """One cell, counted on rank 0 of a fake process group; the artifact is
    written under ``out_dir`` (not at all for ``None``).  ``cfg``, ``shape``
    and ``mesh_shape`` (dims, axis names) replace the arch's config, the
    named shape and the production mesh (the tests' reduced cells)."""
    mesh_name = "x".join(map(str, mesh_shape[0])) if mesh_shape else _MESHES[multi_pod]
    cell: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "sp": sp, "fsdp": fsdp, "moe_impl": moe_impl, "kv_quant": kv_quant,
        "status": "ok",
    }
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mb = bundle(cfg)
    if not mb.supports_shape(shape):
        cell["status"] = "skipped"
        cell["reason"] = _SKIP_REASON
        _write(cell, out_dir, mesh_name, arch, shape_name, tag)
        return cell
    # Weights-stationary inference: FSDP gathering re-collects every weight
    # per decoded token, as the reference decides.
    if shape.kind != "train":
        fsdp = False
        cell["fsdp"] = False

    world = math.prod(mesh_shape[0]) if mesh_shape else (512 if multi_pod else 256)
    prev_moe, prev_remat = moe_mod.get_moe_impl(), transformer.remat_mode()
    try:
        layers.set_kv_quant(kv_quant)
        with _process_group(world):
            mesh = _mesh(multi_pod, mesh_shape)
            n_dev = mesh.size()
            with shd.use_mesh(mesh, sequence_parallel=sp, fsdp=fsdp):
                step, args = build_cell(arch, shape_name, mesh, sp=sp, fsdp=fsdp,
                                        moe_impl=moe_impl, cfg=cfg, shape=shape)
                region = contextlib.nullcontext()
                if shape.kind != "train" and not shd.is_trivial(mesh):
                    from torch.distributed.tensor.experimental import implicit_replication

                    region = implicit_replication()
                counter = CostCounter()
                counter.track_arguments(*args)
                t0 = time.time()
                with region, counter:
                    out = step(*args)
                count_s = time.time() - t0
                output_bytes = local_bytes(out)
                del out, args

        tot = counter.totals
        mf = model_flops(arch, shape_name, cfg, shape)
        flops_total = tot.flops * n_dev
        # booked kernels have no interior here, so the kernelized and the
        # raw memory terms are the same bytes
        hbm_kernelized = max(tot.bytes - tot.kernel_bytes, 0.0)
        cell.update(
            n_devices=n_dev,
            count_s=round(count_s, 2),
            per_device=dict(
                flops=tot.flops,
                hbm_bytes=tot.bytes,
                kernel_interior_bytes=tot.kernel_bytes,
                hbm_bytes_kernelized=hbm_kernelized,
                collective_bytes=tot.collective_bytes,
                argument_bytes=counter.argument_bytes,
                temp_bytes=counter.temp_bytes,
                output_bytes=output_bytes,
            ),
            kernels=counter.kernels,
            model_flops=mf,
            hlo_flops_total=flops_total,
            useful_ratio=(mf / flops_total) if flops_total else None,
            roofline=dict(
                compute_s=flops_total / (n_dev * PEAK_FLOPS),
                memory_s=hbm_kernelized / HBM_BW,
                collective_s=tot.total_collective_bytes / LINK_BW,
                memory_s_raw=tot.bytes / HBM_BW,
            ),
        )
        r = cell["roofline"]
        r["dominant"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: r[k])
    except Exception as e:  # noqa: BLE001 -- an erroring cell is a finding, recorded
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-4000:]
    finally:
        layers.set_kv_quant(False)
        moe_mod.set_moe_impl(prev_moe)
        transformer.set_remat(prev_remat)
    _write(cell, out_dir, mesh_name, arch, shape_name, tag)
    return cell


def _write(cell, out_dir, mesh_name, arch, shape_name, tag=""):
    if out_dir is None:
        return
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    with open(os.path.join(d, f"{arch}__{shape_name}{suffix}.json"), "w") as f:
        json.dump(cell, f, indent=1, default=str)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--sp", action="store_true", help="sequence parallelism")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moe-impl", default="alltoall", choices=["dispatch", "alltoall"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.time()
                cell = run_cell(arch, shape, mp, sp=args.sp, fsdp=not args.no_fsdp,
                                moe_impl=args.moe_impl, out_dir=args.out, tag=args.tag)
                status = cell["status"]
                extra = ""
                if status == "ok":
                    r = cell["roofline"]
                    extra = (
                        f"compute={r['compute_s'] * 1e3:.1f}ms "
                        f"mem={r['memory_s'] * 1e3:.1f}ms "
                        f"coll={r['collective_s'] * 1e3:.1f}ms "
                        f"dom={r['dominant']} useful={cell['useful_ratio']:.2f}"
                    )
                elif status == "error":
                    failures += 1
                    extra = cell["error"][:160]
                print(
                    f"[{time.strftime('%H:%M:%S')}] {arch} x {shape} x "
                    f"{'multi' if mp else 'single'}: {status} "
                    f"({time.time() - t0:.0f}s) {extra}",
                    flush=True,
                )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
