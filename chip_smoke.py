#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):
  1. the device, as nvidia-smi reports its name and power limit;
  2. build every kernel of the serving paths from kernels/csrc (nvcc, all
     sources at once) and print the compiler's register/spill summary for
     each kernel function;
  3. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes and at the reference test sweeps, within the
     stated tolerance (attention bf16 2e-2, f32 2e-5; SSD scan bf16 5e-2,
     f32 5e-5 atol / 5e-4 rtol, the reference sweep's own), each flash and
     SSD case through the body its shape selects (tensor cores for bf16 with
     head dims, or P and N, that are multiples of 16), both decode kernels
     at lengths around their split, the SSD scan around its 64-step chunk
     and on strided views of one tensor as mamba2_block hands them over, and
     the bf16 decode through the paged KV cache (serving.kvcache: pages
     scattered by a shuffled BlockAllocator, paged_decode_attention against
     the plain decode on the contiguous cache);
  4. three engine runs at full width through repro_torch.launch.serve's
     engine path, each of 16 seeded requests with bf16 seeded random weights:
     smollm-135m, zamba2-1.2b (Mamba-2 + shared attention), and smollm-135m
     with an int8 KV cache (layers.set_kv_quant).  The kernels' launch counts
     are zeroed just before each run and read just after; each run must
     have launched the kernels of its path (zamba2: the SSD scan exactly
     once per Mamba-2 layer per request; int8: only the int8 decode kernel;
     every flash and every SSD launch through the tensor-core body), and
     each count must equal EXPECTED_LAUNCHES (the request mix fixes them);
  5. smollm-135m, zamba2-1.2b and xlstm-125m on the card, in bf16 and with
     the same weights in f32, against f32 on the CPU (plain versions):
     prefill and one decode step's logits, and the number of greedy tokens
     that agree;
  6. a JSON ``kernels`` line: per kernel at its serving path's shapes its
     launches in phase 4, its time, its plain version's time, one PyTorch
     call's time where one computes the same function (the attention
     kernels: F.scaled_dot_product_attention, a yardstick the port never
     calls) and the least time the card could take (bound_ms, of the work
     ``repro_torch.kernels.cost`` counts for the launch).  ``ms``,
     ``plain_ms`` and ``library_ms`` are CUDA-event means over 30
     back-to-back Python calls, so they include the host's time per call
     where it exceeds the device's; ``device_ms`` (and ``library_device_ms``
     for the PyTorch call) is the device's own time per call, the durations
     of the device kernels the calls launched, from a torch.profiler trace
     of a second pass of the same 30 calls (``device_ms_source``; "cuda
     events" where the profiler lost every trace, see TRACE_ATTEMPTS).  The two
     attention kernels serve smollm-135m and zamba2-1.2b at different head
     layouts; their entries carry the zamba2 shapes' numbers under "zamba2".
     Each entry's ``launches_by_path`` also counts phase 8's and phase 7's
     launches, and the kernels phase 8 calibrates carry its whole-device f32
     shape's numbers under "calibration" (bound against the f32 peak);
  8. calibration (``phase_calibration``, run before phase 7): the H100 80GB's
     MIG ladder swept by repro_torch.obs.profile at the ``full`` preset with
     emulated slices (MIG is off on the card), launch counts zeroed just
     before and read just after (each of flash, decode and the SSD scan
     6 profiles x 13 calls, all f32 and so through the CUDA-core flash and
     SSD bodies; no int8 decode), each kernel at the preset's whole-device
     shape against its plain version, the artifact's structure, FLOPs and
     bytes checked and loaded into a PerfModel whose rates must be monotone
     over the ladder; printed as a ``{"calibration": ...}`` JSON line;
  7. the placement-integrated cluster on the card (``phase_cluster``),
     planning with phase 8's calibrated PerfModel: smollm-135m "chat" and
     xlstm-125m "draft" replicas sized onto H100 80GB MIG slices, placed,
     served through full-width engines, retired, compacted with a live
     replica's KV cache handed off, reconfigured and pumped to completion,
     printed as a ``{"cluster": ...}`` JSON line;
  9. the placement core at fleet scale (``phase_fleet``) on H100 80GB
     fleets, the demand run planning with phase 8's PerfModel: each case
     runs with the fabric's torch sweep on the card (``fabric_device=
     "cuda"``: at least one full sweep there, none in numpy) and with the
     numpy sweep, held exactly equal: the slabs at 4096 GPUs
     (and 256 rows against the scalar ``can_place_at``), first_fit /
     rule_based / frag_aware deploys at 1024 and 4096 GPUs (the scalar path
     too where it fits the time), a frag_aware online trace over 1024 GPUs
     and a DemandSimulator run on 256 nodes, each with equal layouts and
     stats across backends; printed as a ``{"fleet": ...}`` JSON line;
 10. the four families beyond dense GQA, Mamba-2 and xLSTM (``phase_families``),
     each served at full width through ``serving.Engine`` with bf16 seeded
     weights and only its depth cut (FAMILY_RUNS): mixtral-8x7b (4 of 32
     layers; 8 slots x 8192, a ring of 4096 rows that four requests wrap
     and two fill through the reference's padded-ring path), deepseek-v3-671b
     (4 of 61 layers: 3 dense, 1 MoE of 256 experts), pixtral-12b whole
     (256 patch embeddings per request) and seamless-m4t-large-v2 whole
     (1024 frames per request); launch counts zeroed just before each run
     and read just after, each equal to what the mix fixes (every flash
     launch through the tensor cores, no decode kernel under MLA, one
     Sq = 1 cross-attention flash per decoder layer per step); then each
     family against f32 on the CPU as in phase 5 at the FAMILY_VS_CPU cuts;
     phase 3 holds the kernels at these shapes and phase 6's ``kernels``
     line carries their times under ``families``; printed as a
     ``{"families": ...}`` JSON line;
 11. training (``phase_training``): (a) flash attention and the SSD scan
     under autograd, their ``torch.autograd.Function``s (the kernel forward,
     one launch under the body the shape selects; a plain PyTorch backward)
     against the plain versions' autograd in f32 on the same values, output
     and every gradient, f32 and bf16, at TRAIN_FLASH_CASES and
     TRAIN_SSD_CASE, with a planted control (a window one row short must
     fail); (b) smollm-135m at full width and depth, bf16, trained for 20
     steps through ``launch/train.py``'s loop (TRAIN_ARGS), launch counts
     zeroed just before and read just after: the loss must fall (the
     launcher's own first-tenth vs last-tenth test), flash launched
     layers x steps x 2 (block remat recomputes each forward) times, all
     through the tensor cores, no decode or SSD launch; (c) one f32 step's
     loss and gradients on the card against the CPU at the TRAIN_VS_CPU
     cuts (smollm-135m and zamba2-1.2b at full width, depth cut), and the
     bf16 loss of the same step against the f32 one; (d) the same for every
     architecture at ``reduced()``; (b) also times zamba2-1.2b's training
     step (6 Mamba-2 layers, TRAIN_ZAMBA2) with its SSD and flash launches
     counted; printed as a ``{"training": ...}`` JSON line, and the
     ``kernels`` line counts (b)'s launches under
     ``launches_by_path["training"]``;
 12. distribution (``phase_distribution``): phase 11 (b)'s run again, through
     ``torch.distributed.run`` on one NCCL rank (launch/train.py joins the
     launcher's process group and takes a one-rank mesh, on which every
     tensor stays plain), 50 steps with a checkpoint at step 49, then a
     relaunch that resumes from it to step 100: every step's loss against
     phase 11 (b)'s uninterrupted run within DIST_RESUME_REL, and the two
     launches' kernel counts (each launch's --report) together equal to
     phase 11 (b)'s (flash 6000, all through the tensor cores); printed as
     a ``{"distribution": ...}`` JSON line.  Ranks that share the card over
     gloo are not run: DTensor's all-gather (the functional
     ``all_gather_into_tensor``) crashes there with CUDA tensors
     (tools/gloo_cuda_collectives.py), so the sharded step is held to the
     unsharded one on gloo CPU ranks (tests/test_torch_distributed*.py);
 13. the static cost analysis (``phase_cost_analysis``): (a) the dry-run
     (``python -m repro_torch.launch.dryrun``) of smollm-135m's four shapes
     on a fake 256-rank pod16x16 process group over ``meta`` tensors, in a
     subprocess started before phase 11: train, prefill and decode "ok",
     long_500k skipped; their roofline terms against the H100's datasheet
     peaks, the dominant term and the useful ratio printed, and each cell's
     counted FLOPs x 256 within COST_FLOPS_REL of the analytic count
     (``smollm_analytic_flops``); (b) one rank at phase 11 (b)'s
     shape counted on ``meta``: the flash calls it books a step equal to
     the launches a step phase 11 measured (all ``.tc``) and to one real
     step's, its memory (arguments + peak) within COST_MEM_RANGE of the rise
     in ``max_memory_allocated`` over one real step, and its roofline bound
     as a share of phase 11 (b)'s median step (reported); (c) every arch's
     prefill_32k, decode_32k and long_500k cells at full width on the fake
     pod16x16 group, "ok" or, where the arch does not support the shape as
     the reference decides, "skipped"; (d) every arch's ``reduced()`` train,
     prefill and decode cells on a fake (2, 2) group, all "ok"; in both the
     kernel calls booked equal to ``cost_expected_calls``, the roofline
     terms reported; (e) the sharded train step's loss and every gradient
     leaf on 4 gloo CPU ranks of a (2, 2) mesh against the unsharded step,
     at ``reduced()``, for COST_GLOO_ARCHS, within COST_GLOO_LOSS_REL and
     COST_GLOO_LEAF_REL.  (c)-(e) run in processes of their own at the
     lowest priority, started with (a) before phase 11 (xlstm-125m's
     prefill_32k alone in one: it counts its sLSTM loop's 3 x 32768 steps).
     Printed as a ``{"cost_analysis": ...}`` JSON line with this torch's
     version and every (arch, cell)'s status.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails before printing any
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s,
#: float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
KERNELS = ["flash_attention", "decode_attention", "decode_attention_q8", "ssd_scan"]
#: (atol, rtol) of a kernel against its plain version
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5)}
SSD_TOL = {"bfloat16": (5e-2, 5e-2), "float32": (5e-5, 5e-4)}  # tests/test_kernels.py's
#: card (bf16) vs CPU (f32) logits: bf16 keeps 8 significant bits, about
#: 0.2% per rounding.  smollm-135m: ~12 roundings per layer over 30 layers;
#: zamba2-1.2b: ~15 per Mamba-2 layer over 38 and ~12 per shared attention
#: application over 6 (its recurrent state stays f32 on both sides).  Either
#: random-walks to ~5% of the logit scale, so allow 10% of the largest
#: reference logit.
ENGINE_REL_TOL = 0.1
#: card (bf16) vs CPU (f32) logits for xlstm-125m, set from two readings.
#: (1) The reference's own bf16 vs f32 error at this phase's weights and
#: prompt (JAX on the host CPU, jitted as its engine runs it) is 41.3% of the
#: largest logit at prefill and 29.7% at the decode step, and the port's f32
#: differs from the reference's f32 by 1.5e-4 / 6.8e-5 (summation order
#: alone): the stack amplifies any rounding difference, so bf16 noise is
#: this large in the reference itself (tests/test_torch_xlstm.py::
#: test_bf16_error_at_chip_smoke_weights_is_the_references, on an H100).
#: (2) Block by block the port rounds where the reference does
#: (test_bf16_block_rounds_as_the_reference, CPU).  The port's error is so a
#: draw of the same size; 0.5 is the reference's prefill reading plus a
#: fifth.  It catches gross faults only: the f32 pair below and the block
#: witness are the checks that tell a wrong computation from rounding.
XLSTM_REL_TOL = 0.5
#: card (f32, TF32 off) vs CPU (f32): the same math summed in another order,
#: ~1e-7 relative per rounding; ~1e-5 of the logit scale after the layers,
#: so 1e-3 leaves two orders of magnitude.
ENGINE_F32_REL_TOL = 1e-3
MIX = ["--device", "cuda", "--slots", "8", "--max-len", "2048", "--requests", "16",
       "--prompt-len", "32", "701", "--min-new", "32", "--max-new", "65", "--seed", "0"]
SMOLLM, ZAMBA2, XLSTM = "smollm-135m", "zamba2-1.2b", "xlstm-125m"
INT8 = "smollm-135m int8-KV"
#: launches per kernel in each engine run of MIX (16 prefills, 115 decode
#: steps): smollm 30 attention layers, zamba2 38 Mamba-2 layers and 6 shared
#: attention applications
EXPECTED_LAUNCHES = {
    SMOLLM: {"flash_attention": 480, "decode_attention": 3450, "decode_attention_q8": 0,
             "ssd_scan": 0},
    ZAMBA2: {"flash_attention": 96, "decode_attention": 690, "decode_attention_q8": 0,
             "ssd_scan": 608},
    INT8: {"flash_attention": 480, "decode_attention": 0, "decode_attention_q8": 3450,
           "ssd_scan": 0},
}
#: phase 10: the four families served at full width, cut in depth only
MIXTRAL, DEEPSEEK, PIXTRAL, SEAMLESS = ("mixtral-8x7b", "deepseek-v3-671b", "pixtral-12b",
                                        "seamless-m4t-large-v2")
FAMILIES = (MIXTRAL, DEEPSEEK, PIXTRAL, SEAMLESS)
#: arch -> (config overrides of the engine run, slots, max_len, requests).
#: Mixtral: 4 of 32 layers, a ring of 4096 rows (the window) at max_len
#: 8192; prompts whose bucket is 4096 (four of them wrap the ring in their
#: 160 new tokens) and two whose bucket of 8192 takes the reference's padded
#: ring (ROADMAP queue C).  DeepSeek-V3: 4 of 61 layers, its 3 dense layers
#: and 1 MoE layer of 256 experts, phase 4's prompt distribution.  Pixtral
#: and Seamless whole.
FAMILY_RUNS = {
    MIXTRAL: (dict(n_layers=4), 8, 8192,
              dict(lens=[2100, 3000, 3950, 3990, 4000, 4090, 4500, 5000], new=(160, 161))),
    DEEPSEEK: (dict(n_layers=4), 8, 2048, dict(prompt=(32, 701), new=(32, 65))),
    PIXTRAL: ({}, 8, 2048, dict(prompt=(256, 701), new=(32, 65))),
    SEAMLESS: ({}, 8, 2048, dict(prompt=(32, 257), new=(32, 65))),
}
#: the card-vs-CPU comparison's cuts, which fit the host's RAM in f32
#: (DeepSeek-V3's 32 routed experts are the one cut of a non-depth width).
#: Mixtral's window of 64 makes its cache a ring of 64 rows at
#: VS_CPU_MAX_LEN: the 100-token prompt takes the prefill of s >= Smax rows
#: (the engine's bucket of 128, the padded ring) and its decode steps wrap
#: the ring, each against the CPU
FAMILY_VS_CPU = {
    MIXTRAL: dict(n_layers=2, sliding_window=64),
    DEEPSEEK: dict(n_layers=2, n_dense_layers=1, n_experts=32),
    PIXTRAL: dict(n_layers=2),
    SEAMLESS: dict(n_layers=2, n_encoder_layers=2),
}
VS_CPU_MAX_LEN = 512
#: free-running card bf16 readings of phase 10 that are reported and not
#: held to ENGINE_REL_TOL, by family: those of the MoE families that the
#: reference's own bf16 exceeds too.  Over 8 draws at the FAMILY_VS_CPU cut
#: (weights seeded 0 and 1 x prompts seeded 7-10; tests/test_torch_families
#: .py::test_moe_bf16_error_spread_over_prompts_and_seeds, JAX on the card
#: host's CPU; H100 80GB HBM3, 700 W), as a share of the largest logit:
#:   DeepSeek-V3 prefill: reference 3.2-14.3% (above 0.1 at 2 draws), port
#:     4.0-31.8% (at 3); decode: both 1.1-1.5% at every draw, so gated;
#:   Mixtral prefill: reference 1.2-82.2% (at 5), port 1.4-72.3% (at 7);
#:     decode: reference 1.1-8.2%, port 1.0-11.0% (at 1).
#: With the f32 run's routing the port's bf16 reads 0.8-1.5% at every draw
#: of both, and the two packages' f32 runs agree to 8.4e-6.  Under bf16 a
#: token's k-th expert can change, and through the token-major capacity
#: that moves which later tokens an expert drops, each drop a whole
#: expert's share of a token's output: a reading is a draw with a heavy
#: tail in either package, and a limit set from 8 draws would fail on the
#: next prompt or catch nothing.  The arithmetic is held by the f32-routed
#: run, gated to ENGINE_REL_TOL at prefill and decode.
BF16_FREE_RUN_UNGATED = {MIXTRAL: ("prefill", "decode"), DEEPSEEK: ("prefill",)}
FAMILY_PHASE_TARGET_S = 300.0
#: phase 3 holds flash and decode at phase 10's shapes to their plain
#: versions in f32 on the same bf16 inputs.  Over n keys an output is about
#: sqrt(e/n) of the values' scale (0.026 at 4096), the size of TOL's bf16
#: atol, so there the limit scales with the output: an element may be off
#: by FAMILY_ROUND of its own size (the output's rounding to bf16, 2^-9 at
#: most, twice over) plus FAMILY_ROW_TOL of its row's rms over the head
#: dimension.  The tensor-core flash rounds its probabilities to bf16, an
#: error of about 2^-9 / sqrt(3) of the row's rms per element, so ~0.006 at
#: 5.5 sigma over the millions of elements of a shape; a key tile of 64
#: lost or gained moves a row of n keys by about sqrt(64 / n) of its rms
#: (0.125 at 4096), and the planted controls show that it fails.
FAMILY_ROW_TOL, FAMILY_ROUND = 0.03, 2.0 ** -8
#: torch.profiler traces taken before a kernel's device time falls back to
#: CUDA events.  About one fresh session in 600 on an H100 (torch 2.11)
#: records no device kernel while all its launches are on the CPU side, with
#: or without a pause before it ends (tools/profiler_trace_loss.py): a loss
#: inside the profiler's collection, so an empty trace is taken again.  The
#: losses can come in a run of consecutive sessions (three in a row at one
#: decode shape on an H100), so after TRACE_ATTEMPTS empty traces the time
#: is read from CUDA events around the same calls instead (an upper bound on
#: the device's time: it includes the gaps between launches).
TRACE_ATTEMPTS = 3
TRACE_RETRY_PAUSE_S = 0.2
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(label: str, got, want, dtype_name: str, tols=TOL) -> float:
    import torch

    atol, rtol = tols[dtype_name]
    err = max_err(got, want)
    ok = bool(torch.all((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()))
    log(f"  {label}: max_abs_err={err:.3e} atol={atol:g} rtol={rtol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return err


def time_ms(fn, inputs, iters: int = 30) -> float:
    """Mean ms per call over back-to-back calls, cycling through input sets
    that together exceed the 50 MB L2, as the serving loop finds them."""
    import torch

    for x in inputs[:3]:
        fn(*x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, names=(), iters: int = 30):
    """Device time per call: the summed durations of the device kernels that
    ``iters`` calls launch (only those whose names contain one of ``names``,
    where given), from a torch.profiler trace.  Returns (ms, source, ms per
    call by kernel name).  A trace that holds no such device event is taken
    again after a pause, up to TRACE_ATTEMPTS traces in all; if none holds
    one, the time is CUDA events' around ``iters`` calls (source "cuda
    events", one entry for the whole call; see TRACE_ATTEMPTS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for x in inputs[:3]:
        fn(*x)
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and (not names or any(n in e.name for n in names))]
        if events:
            break
        log(f"  device time: trace {attempt} of {TRACE_ATTEMPTS} recorded no device kernel "
            f"{names}")
        time.sleep(TRACE_RETRY_PAUSE_S)
    else:
        ms = time_ms(fn, inputs, iters)
        log(f"  device time: {ms:.4f} ms per call from CUDA events instead")
        return ms, "cuda events", {"+".join(names) or "whole call": ms}
    by_name = {}
    for e in events:
        key = e.name[:80]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / iters / 1e3
    return sum(by_name.values()), "torch.profiler", dict(sorted(by_name.items()))


def copies_past_l2(nbytes: int) -> int:
    return max(2, math.ceil(64e6 / max(nbytes, 1)))


# ---------------------------------------------------------------------------
def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(out)
    return out


def phase_build(_build):
    t0 = time.perf_counter()
    secs = _build.build(KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in secs.items()) or 'cached'})")
    cxxfilt = shutil.which("c++filt")
    for lib in sorted(_build.BUILD_DIR.glob("*.log")):
        fn = "?"
        for line in lib.read_text().splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                fn = entry.group(1)
                if cxxfilt:
                    fn = subprocess.run([cxxfilt, fn], capture_output=True,
                                        text=True).stdout.strip() or fn
            elif "registers" in line or "spill" in line:
                log(f"  {lib.stem}: {fn}: {line.strip()}")


def phase_kernels(torch, ops, ref, fa, dec, q8, ssd):
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    flash_cases = [
        # (label, dtype, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window)
        ("smollm prefill S=512", "bfloat16", 1, 512, 512, 9, 3, 64, 64, True, None),
        ("smollm prefill S=1024", "bfloat16", 1, 1024, 1024, 9, 3, 64, 64, True, None),
    ] + [
        (f"zamba2 shared attention S={s_}", dn, 1, s_, s_, 32, 32, 64, 64, True, None)
        for s_ in (32, 300, 700) for dn in ("bfloat16", "float32")
    ] + [
        ("odd S=300", "bfloat16", 1, 300, 300, 9, 3, 64, 64, True, None),
        ("odd S=300", "float32", 1, 300, 300, 9, 3, 64, 64, True, None),
        ("Sq<Sk 100/300", "float32", 2, 100, 300, 8, 2, 64, 64, True, None),
        ("Sq>Sk non-causal 150/77", "float32", 2, 150, 77, 6, 2, 64, 64, False, None),
        ("Dv!=D non-causal", "float32", 1, 77, 150, 4, 4, 128, 256, False, None),
        ("window 32", "float32", 2, 256, 256, 4, 2, 64, 64, True, 32),
        ("window 100", "float32", 2, 256, 256, 4, 2, 64, 64, True, 100),
        ("window 256", "float32", 2, 256, 256, 4, 2, 64, 64, True, 256),
        ("non-causal MHA", "float32", 1, 128, 128, 4, 4, 64, 64, False, None),
    ] + [  # the tensor-core body's tile edges and ragged tails
        (f"D=Dv={d_}", "bfloat16", 2, 300, 300, 8, 2, d_, d_, True, None)
        for d_ in (32, 80, 128, 256)
    ] + [
        ("D=128 Dv=256 non-causal", "bfloat16", 1, 77, 150, 4, 4, 128, 256, False, None),
        ("D=128 Dv=256 Sq<Sk", "bfloat16", 2, 100, 300, 4, 2, 128, 256, True, None),
        ("Sq<Sk 100/300", "bfloat16", 2, 100, 300, 8, 2, 64, 64, True, None),
        ("Sq<Sk 1/300", "bfloat16", 2, 1, 300, 9, 3, 64, 64, True, None),
        ("window 32", "bfloat16", 2, 256, 256, 4, 2, 64, 64, True, 32),
        ("window 100", "bfloat16", 2, 256, 256, 4, 2, 64, 64, True, 100),
        ("window 100 S=300", "bfloat16", 2, 300, 300, 9, 3, 64, 64, True, 100),
        ("Sq>Sk non-causal 150/77", "bfloat16", 2, 150, 77, 6, 2, 64, 64, False, None),
        ("D=40 (CUDA-core body)", "bfloat16", 1, 128, 128, 4, 2, 40, 40, True, None),
    ] + [
        (f"S={s_}", "bfloat16", 2, s_, s_, 9, 3, 64, 64, True, None)
        for s_ in (1, 15, 17, 300, 1023)
    ]
    for dn in ("float32", "bfloat16"):  # tests/test_kernels.py flash sweep
        for b, s, hq, hkv, d in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 6, 1, 32),
                                 (2, 128, 4, 2, 80)]:
            flash_cases.append((f"sweep {b}x{s}x{hq}/{hkv}x{d}", dn, b, s, s, hq, hkv, d, d,
                                True, None))
    log("kernels vs plain versions on the card:")
    for label, dn, b, sq, sk, hq, hkv, d, dv, causal, win in flash_cases:
        q, k, v = rn((b, sq, hq, d), dts[dn]), rn((b, sk, hkv, d), dts[dn]), rn((b, sk, hkv, dv), dts[dn])
        want_body = "tc" if dn == "bfloat16" and d % 16 == 0 and dv % 16 == 0 else "simt"
        if fa.body(q, k, v) != want_body:
            raise AssertionError(f"flash_attention {label} {dn}: body {fa.body(q, k, v)}, "
                                 f"expected {want_body}")
        before = ops.launch_counts().get(f"flash_attention.{want_body}", 0)
        got = fa.flash_attention_cuda(q, k, v, causal, win)
        torch.cuda.synchronize()
        require(ops.launch_counts(), f"flash_attention.{want_body}",
                ops.launch_counts().get(f"flash_attention.{want_body}", 0) == before + 1,
                f"{before + 1}")
        check_close(f"flash_attention {label} {dn} ({want_body})", got,
                    ref.attention_ref(q, k, v, causal, win), dn)
    dec_cases = [
        ("smollm 8 slots, Smax=2048", "bfloat16", 8, 2048, 9, 3, 64,
         [1, 2048, 3000, 5, 700, 64, 65, 128]),
        ("smollm 8 slots, Smax=2048", "float32", 8, 2048, 9, 3, 64,
         [1, 2048, 2049, 5, 700, 64, 65, 128]),
        ("ragged", "float32", 4, 256, 8, 2, 64, [1, 64, 137, 256]),
    ] + [
        ("zamba2 8 slots, Smax=2048, G=1", dn, 8, 2048, 32, 32, 64,
         [0, 2048, 3000, 1, 700, 64, 65, 33]) for dn in ("bfloat16", "float32")
    ]
    sp = dec.SPLIT  # lengths around the split-K boundaries, in one batch
    edges = [0, 1, sp - 1, sp, sp + 1, 2048, 3000, 700]
    dec_cases += [(f"split edges {edges}", dn, 8, 2048, hq_, hkv_, 64, edges)
                  for dn in ("bfloat16", "float32") for hq_, hkv_ in ((9, 3), (32, 32))]
    for dn in ("float32", "bfloat16"):  # tests/test_kernels.py decode sweep
        for b, smax, hq, hkv, d, n in [(2, 256, 8, 2, 64, 137), (1, 512, 4, 4, 64, 512),
                                       (3, 128, 4, 1, 32, 1), (2, 256, 16, 2, 64, 200)]:
            dec_cases.append((f"sweep {b}x{smax}x{hq}/{hkv}x{d} len={n}", dn, b, smax, hq, hkv,
                              d, [n] * b))
    for label, dn, b, smax, hq, hkv, d, lens in dec_cases:
        q, k, v = rn((b, 1, hq, d), dts[dn]), rn((b, smax, hkv, d), dts[dn]), rn((b, smax, hkv, d), dts[dn])
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = dec.decode_attention_cuda(q, k, v, length)
        torch.cuda.synchronize()
        check_close(f"decode_attention {label} {dn}", got, ref.decode_attention_ref(q, k, v, length), dn)
    # a scalar length is broadcast to every sequence
    q, k, v = rn((2, 1, 9, 64), torch.bfloat16), rn((2, 512, 3, 64), torch.bfloat16), rn((2, 512, 3, 64), torch.bfloat16)
    check_close("decode_attention scalar length 300 bfloat16", dec.decode_attention_cuda(q, k, v, 300),
                ref.decode_attention_ref(q, k, v, 300), "bfloat16")
    check_paged_decode(torch, ops, ref, rn)
    check_family_shapes(torch, ops, ref, fa, dec, rn)

    q8_cases = [
        ("smollm 8 slots, Smax=2048", dn, 8, 2048, 9, 3, 64, [1, 2048, 3000, 5, 700, 64, 65, 128])
        for dn in ("bfloat16", "float32")
    ]
    sp = q8.SPLIT  # lengths around the split-K boundaries, in one batch
    edges = [0, 1, sp - 1, sp, sp + 1, 2048, 3000, 700]
    q8_cases += [(f"split edges {edges}", dn, 8, 2048, hq_, hkv_, 64, edges)
                 for dn in ("bfloat16", "float32") for hq_, hkv_ in ((9, 3), (32, 32))]
    for b, smax, hq, hkv, d, n in [(2, 256, 8, 2, 64, 137), (1, 512, 4, 4, 64, 512),
                                   (2, 256, 16, 2, 64, 200)]:  # tests/test_kernels.py q8 sweep
        q8_cases.append((f"sweep {b}x{smax}x{hq}/{hkv}x{d} len={n}", "float32", b, smax, hq, hkv,
                         d, [n] * b))
    q8_cases.append(("ragged", "float32", 3, 256, 8, 2, 64, [7, 256, 100]))
    for label, dn, b, smax, hq, hkv, d, lens in q8_cases:
        q = rn((b, 1, hq, d), dts[dn])
        kq, ks = ref.quantize_kv(rn((b, smax, hkv, d), torch.float32))
        vq, vs = ref.quantize_kv(rn((b, smax, hkv, d), torch.float32))
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = q8.decode_attention_q8_cuda(q, kq, ks, vq, vs, length)
        torch.cuda.synchronize()
        check_close(f"decode_attention_q8 {label} {dn}", got,
                    ref.decode_attention_q8_ref(q, kq, ks, vq, vs, length), dn)

    ssd_cases = [  # (label, dtype, B, S, H, P, N, initial state)
        (f"zamba2 prefill S={s_}{' +h0' if h0 else ''}", dn, 1, s_, 32, 128, 64, h0)
        for s_ in (1, 33, 63, 64, 65, 128, 300, 673, 700) for dn in ("bfloat16", "float32")
        for h0 in (False, True)
    ]
    for dn in ("float32", "bfloat16"):  # tests/test_kernels.py ssd sweep
        for b, s_, h, p, n in [(1, 128, 2, 16, 8), (2, 256, 4, 32, 16), (1, 64, 8, 8, 64)]:
            ssd_cases.append((f"sweep {b}x{s_}x{h}x{p}x{n}", dn, b, s_, h, p, n, False))
    for label, dn, b, s_, h, p, n, with_h0 in ssd_cases:
        x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dts[dn], b, s_, h, p, n)
        h0 = rn((b, h, p, n), torch.float32) if with_h0 else None
        want_body = "tc" if dn == "bfloat16" and p % 16 == 0 and n % 16 == 0 else "simt"
        y, hT = run_ssd(torch, ops, ssd, want_body, f"{label} {dn}", x, dt, A, Bm, Cm, h0)
        wy, wh = ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0)
        check_close(f"ssd_scan y {label} {dn} ({want_body})", y, wy, dn, SSD_TOL)
        check_close(f"ssd_scan hT {label} {dn} ({want_body})", hT, wh, dn, SSD_TOL)
    # x, B, C as views of one (B, S, d_inner + 2N) convolution output, as
    # mamba2_block hands them over: read in place, equal to contiguous copies
    for dn in ("bfloat16", "float32"):
        for s_ in (65, 673):
            h, p, n = 32, 128, 64
            _, dt, A, _, _ = ssd_inputs(torch, gen, dts[dn], 1, s_, h, p, n)
            xbc = (torch.randn((1, s_, h * p + 2 * n), generator=gen, device="cuda") * 0.5).to(dts[dn])
            x = xbc[..., :h * p].reshape(1, s_, h, p)
            Bm, Cm = xbc[..., h * p: h * p + n], xbc[..., h * p + n:]
            want_body = "tc" if dn == "bfloat16" else "simt"
            label = f"strided views S={s_} {dn}"
            y, hT = run_ssd(torch, ops, ssd, want_body, label, x, dt, A, Bm, Cm, None)
            yc, hc = ssd.ssd_scan_cuda(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())
            torch.cuda.synchronize()
            if not (torch.equal(y, yc) and torch.equal(hT, hc)):
                raise AssertionError(f"ssd_scan {label}: strided and contiguous inputs differ")
            wy, wh = ref.ssd_scan_ref(x, dt, A, Bm, Cm)
            check_close(f"ssd_scan y {label} ({want_body}, == contiguous)", y, wy, dn, SSD_TOL)
            check_close(f"ssd_scan hT {label} ({want_body}, == contiguous)", hT, wh, dn, SSD_TOL)


def shuffled_allocator(BlockAllocator, n_blocks: int, seed: int):
    """An allocator that hands out its blocks in a seeded random order: each
    block taken alone, then all freed in a shuffled order."""
    alloc = BlockAllocator(n_blocks)
    for i in range(n_blocks):
        alloc.allocate(-1 - i)
    for i in random.Random(seed).sample(range(n_blocks), n_blocks):
        alloc.free(-1 - i)
    return alloc


def check_paged_decode(torch, ops, ref, rn):
    """smollm-135m's decode shape (8 slots, 9/3 heads, D 64, bf16) through
    the paged KV cache: 16-token pages handed out by a shuffled allocator,
    written with append_batch, gathered and decoded by the split-K kernel
    (one decode_attention launch), against the plain decode on the
    contiguous cache."""
    from repro_torch.serving.kvcache import BlockAllocator, PagedKVCache, paged_decode_attention

    lens, bs, smax, hq, hkv, d = [1, 16, 17, 2048, 700, 64, 65, 128], 16, 2048, 9, 3, 64
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    alloc = shuffled_allocator(BlockAllocator, n_blocks, seed=0)
    cache = PagedKVCache.create(n_blocks, bs, hkv, d, torch.bfloat16, device="cuda")
    k, v = rn((8, smax, hkv, d), torch.bfloat16), rn((8, smax, hkv, d), torch.bfloat16)
    tables = torch.zeros((8, smax // bs), dtype=torch.int32)
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = 0, 0  # the contiguous cache holds nothing past the length
        blocks = torch.tensor(alloc.allocate(b, -(-n // bs)), dtype=torch.int32)
        tables[b, :len(blocks)] = blocks
        t = torch.arange(n)
        cache = cache.append_batch(blocks[t // bs], t % bs, k[b, :n], v[b, :n])
    q = rn((8, 1, hq, d), torch.bfloat16)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = ops.launch_counts().get("decode_attention", 0)
    got = paged_decode_attention(q, cache, tables.cuda(), length)
    torch.cuda.synchronize()
    require(ops.launch_counts(), "decode_attention",
            ops.launch_counts().get("decode_attention", 0) == before + 1, f"{before + 1}")
    check_close(f"paged decode_attention {bs}-token pages, lengths {lens} bfloat16", got,
                ref.decode_attention_ref(q, k, v, length), "bfloat16")


def family_kernel_shapes(cfg, slots: int, max_len: int, seq_lens, decode_lens):
    """The kernel shapes a family's engine gives flash and the bf16 decode,
    from its config: flash cases (B, Sq, Sk, Hq, Hkv, D, Dv, causal, window)
    for a prefill of each length in ``seq_lens`` (an encoder-decoder adds
    its encoder over the frames, and cross-attention at that prefill and at
    a decode step of ``slots`` rows), and decode cases (lengths, Hq, Hkv, D,
    Smax) at ``decode_lens`` over the engine's cache (a ring of the window's
    rows where there is one); none under MLA, whose decode is einsums."""
    if cfg.attention == "mla":
        hq = hkv = cfg.n_heads
        d, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    else:
        hq, hkv, d, dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.head_dim_
    win = cfg.sliding_window
    flash = [(1, s_, s_, hq, hkv, d, dv, True, win) for s_ in seq_lens]
    if cfg.enc_dec:
        e = cfg.frontend_len
        flash = ([(1, e, e, hq, hkv, d, dv, False, None)] + flash
                 + [(1, s_, e, hq, hkv, d, dv, False, None) for s_ in seq_lens]
                 + [(slots, 1, e, hq, hkv, d, dv, False, None)])
    smax = min(max_len, win) if win else max_len
    decode = [] if cfg.attention == "mla" else [(list(decode_lens), hq, hkv, d, smax)]
    return flash, decode


#: phase 3's prefill lengths and decode lengths for each family's shapes:
#: Mixtral at and past its window, with slots below, at and past its ring
#: of 4096 rows (a wrapped ring attends to every row)
FAMILY_CHECK_LENS = {
    MIXTRAL: ([4096, 8192], [4096, 4097, 4255, 2100, 4095, 5000, 1, 4160]),
    DEEPSEEK: ([1024], []),
    PIXTRAL: ([1024], [300, 2048, 700, 257, 1, 64, 65, 1000]),
    SEAMLESS: ([256], [33, 256, 100, 64, 65, 1, 200, 150]),
}


def family_check_cases():
    """Phase 3's cases of phase 10's kernel shapes, by family: (flash cases,
    decode cases) as family_kernel_shapes gives them at FAMILY_CHECK_LENS,
    each config cut as its engine run (FAMILY_RUNS)."""
    from repro_torch.configs import get_config

    out = {}
    for arch, (seq_lens, decode_lens) in FAMILY_CHECK_LENS.items():
        over, slots, max_len, _ = FAMILY_RUNS[arch]
        out[arch] = family_kernel_shapes(dataclasses.replace(get_config(arch), **over), slots,
                                         max_len, seq_lens, decode_lens)
    return out


def row_scaled_err(got, want) -> float:
    """The largest error of ``got`` against the f32 plain output ``want``,
    less FAMILY_ROUND of the element's own size, over the rms of its output
    row (the last dimension)."""
    want = want.float()
    err = (got.float() - want).abs() - FAMILY_ROUND * want.abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
    return float((err / rms).max())


def check_scaled(label: str, got, want, planted) -> float:
    """A kernel at one of phase 10's shapes against its plain version in f32:
    row_scaled_err within FAMILY_ROW_TOL; and the planted control, the plain
    version of a call that is wrong by one 64-key tile, must exceed it."""
    r = row_scaled_err(got, want)
    log(f"  {label}: max_abs_err={max_err(got, want):.3e} row-scaled={r:.3e} "
        f"tol={FAMILY_ROW_TOL:g} {'ok' if r <= FAMILY_ROW_TOL else 'FAIL'}")
    if r > FAMILY_ROW_TOL:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    plabel, pwant = planted
    pr = row_scaled_err(got, pwant)
    log(f"    planted control, {plabel}: row-scaled={pr:.3e} "
        f"{'caught' if pr > FAMILY_ROW_TOL else 'MISSED'}")
    if pr <= FAMILY_ROW_TOL:
        raise AssertionError(f"{label}: the check passes a plain version {plabel}")
    return r


def check_family_shapes(torch, ops, ref, fa, dec, rn, archs=FAMILIES):
    """Flash and the bf16 decode at the shapes of phase 10's ``archs``
    (family_check_cases), each held to its plain version in f32 on the same
    bf16 inputs by check_scaled.  The planted controls: flash against a
    window (or, with none, the keys) 64 shorter; decode with the slot that
    reaches furthest (a wrapped ring's Smax) cut by 64 rows, one split."""
    cases = family_check_cases()
    for arch in archs:
        flash, decode = cases[arch]
        for b, sq, sk, hq, hkv, d, dv, causal, win in flash:
            q, k, v = (rn((b, sq, hq, d), torch.bfloat16), rn((b, sk, hkv, d), torch.bfloat16),
                       rn((b, sk, hkv, dv), torch.bfloat16))
            before = ops.launch_counts().get("flash_attention.tc", 0)
            got = fa.flash_attention_cuda(q, k, v, causal, win)
            torch.cuda.synchronize()
            require(ops.launch_counts(), "flash_attention.tc",
                    ops.launch_counts().get("flash_attention.tc", 0) == before + 1,
                    f"{before + 1}")
            q32, k32, v32 = q.float(), k.float(), v.float()
            want = ref.attention_ref(q32, k32, v32, causal, win)
            short = (win or sk) - 64
            planted = (f"window {short}", ref.attention_ref(q32, k32, v32, causal, short))
            check_scaled(f"flash_attention {arch} q({b},{sq},{hq},{d}) k({b},{sk},{hkv},{d}) "
                         f"v(.., {dv}) {'causal' if causal else 'non-causal'}"
                         f"{f' window {win}' if win else ''} bfloat16 (tc)", got, want, planted)
            del q32, k32, v32, want, planted
            torch.cuda.empty_cache()
        for lens, hq, hkv, d, smax in decode:
            b = len(lens)
            q, k, v = (rn((b, 1, hq, d), torch.bfloat16), rn((b, smax, hkv, d), torch.bfloat16),
                       rn((b, smax, hkv, d), torch.bfloat16))
            length = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = dec.decode_attention_cuda(q, k, v, length)
            torch.cuda.synchronize()
            q32, k32, v32 = q.float(), k.float(), v.float()
            far = max(range(b), key=lambda i: min(lens[i], smax))
            cut = list(lens)
            cut[far] = min(lens[far], smax) - 64
            cut = torch.tensor(cut, dtype=torch.int32, device="cuda")
            planted = (f"slot {far} at {min(lens[far], smax) - 64} rows",
                       ref.decode_attention_ref(q32, k32, v32, cut))
            check_scaled(f"decode_attention {arch} q({b},1,{hq},{d}) cache({b},{smax},{hkv},{d}) "
                         f"lengths {lens} bfloat16", got,
                         ref.decode_attention_ref(q32, k32, v32, length), planted)


def run_ssd(torch, ops, ssd, want_body, label, x, dt, A, Bm, Cm, h0):
    """One ssd_scan_cuda call that must take ``want_body`` and count once
    under it."""
    if ssd.body(x, Bm, Cm) != want_body:
        raise AssertionError(f"ssd_scan {label}: body {ssd.body(x, Bm, Cm)}, expected {want_body}")
    before = ops.launch_counts().get(f"ssd_scan.{want_body}", 0)
    out = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    require(ops.launch_counts(), f"ssd_scan.{want_body}",
            ops.launch_counts().get(f"ssd_scan.{want_body}", 0) == before + 1, f"{before + 1}")
    return out


def ssd_inputs(torch, gen, dtype, b, s, h, p, n):
    """The reference sweep's inputs: x, B, C scaled by 0.5, dt = softplus(N(0,1))
    in f32, A = -exp(0.3 N(0,1)) in f32."""
    def rn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (rn((b, s, h, p)) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rn((b, s, h)))
    A = -torch.exp(rn((h,)) * 0.3)
    return x, dt, A, (rn((b, s, n)) * 0.5).to(dtype), (rn((b, s, n)) * 0.5).to(dtype)


def phase_engine(torch, ops, serve, layers, arch: str, kv_quant: bool = False):
    """One engine run of the request mix; launch counts zeroed just before
    and read just after."""
    argv = ["--arch", arch] + MIX
    log(f"engine at full width{' (int8 KV cache)' if kv_quant else ''}: {' '.join(argv)}")
    args = serve.parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers.set_kv_quant(kv_quant)
    try:
        ops.reset_launch_counts()
        res = serve.run_engine(args)
        counts = ops.launch_counts()
    finally:
        layers.set_kv_quant(False)
    st = res["stats"]
    reqs = serve.make_requests(args, res["bundle"].cfg.vocab_size)
    log(f"  {len(res['completions'])} completions, {res['tokens']} tokens in "
        f"{res['seconds']:.3f}s = {res['tok_per_s']:.1f} tok/s, {st['decode_steps']} decode "
        f"steps, {st['prefills']} prefills, launches {counts}")
    log(f"  params {res['bundle'].param_count()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    assert len(res["completions"]) == args.requests
    for c, r in zip(sorted(res["completions"], key=lambda c: int(c.rid[3:])), reqs):
        assert len(c.tokens) == r.max_new_tokens and c.finish_reason == "length", c.rid
    return res, counts, reqs


def require(counts, name: str, ok: bool, want: str) -> None:
    if not ok:
        raise AssertionError(f"{name} launched {counts.get(name, 0)} times, expected {want}")


def require_tc(counts) -> None:
    """Every flash and every SSD launch of an engine run went through the
    tensor-core body."""
    for name in ("flash_attention", "ssd_scan"):
        n = counts.get(name, 0)
        require(counts, f"{name}.tc", counts.get(f"{name}.tc", 0) == n, f"{n}")


def require_expected(counts, path: str) -> None:
    for name, n in EXPECTED_LAUNCHES[path].items():
        require(counts, name, counts.get(name, 0) == n, f"{n} in the {path} run")


def phase_engines(torch, ops, serve, layers):
    runs = {}
    res, counts, reqs = phase_engine(torch, ops, serve, layers, SMOLLM)
    for name in ("flash_attention", "decode_attention"):
        require(counts, name, counts.get(name, 0) > 0, "> 0")
    require_tc(counts)
    require_expected(counts, SMOLLM)
    runs[SMOLLM] = (res, counts, reqs)

    res, counts, reqs = phase_engine(torch, ops, serve, layers, ZAMBA2)
    model = res["bundle"].model
    n_mamba = sum(n for kind, n in model._groups() if kind == "mamba2")
    n_req = len(reqs)
    require(counts, "ssd_scan", counts.get("ssd_scan", 0) == n_req * n_mamba,
            f"{n_req} x {n_mamba}")
    require(counts, "flash_attention", counts.get("flash_attention", 0) ==
            n_req * model.n_shared_apps, f"{n_req} x {model.n_shared_apps}")
    require(counts, "decode_attention", counts.get("decode_attention", 0) > 0, "> 0")
    require_tc(counts)
    require_expected(counts, ZAMBA2)
    runs[ZAMBA2] = (res, counts, reqs)

    res, counts, reqs = phase_engine(torch, ops, serve, layers, SMOLLM, kv_quant=True)
    require(counts, "decode_attention_q8", counts.get("decode_attention_q8", 0) > 0, "> 0")
    require(counts, "decode_attention", counts.get("decode_attention", 0) == 0, "0")
    require(counts, "flash_attention", counts.get("flash_attention", 0) > 0, "> 0")
    require_tc(counts)
    require_expected(counts, INT8)
    runs[INT8] = (res, counts, reqs)
    return runs


@contextlib.contextmanager
def moe_routes(routes: list, replay: bool = False):
    """Within: every MoE layer's routing is recorded into ``routes`` or, with
    ``replay``, taken from it in order, moved to the tokens' device."""
    from repro_torch.models import moe

    real = moe._route
    if replay:
        taken = iter(routes)
        moe._route = lambda p, xt, c: tuple(t.to(xt.device) for t in next(taken))
    else:
        moe._route = lambda p, xt, c: routes.append(real(p, xt, c)) or routes[-1]
    try:
        yield
    finally:
        moe._route = real


def vs_cpu_prompt(vocab_size: int, prompt_len: int, seed: int = 7):
    return list(map(int, np.random.default_rng(seed).integers(1, vocab_size, size=prompt_len)))


def prefill_and_step(torch, mb, params, prompt, extras, max_len: int, dev, nxt=None):
    """One prefill of ``prompt`` and one decode step on ``dev``, fed ``nxt``
    (default: the prefill's greedy token).  Returns the two logits on the
    CPU and the token fed."""
    toks = torch.tensor([prompt], device=dev)
    with torch.no_grad():
        lg, cache = mb.prefill_fn(params, {"tokens": toks, **extras}, max_len=max_len)
        nxt = torch.argmax(lg[0, -1]).view(1, 1) if nxt is None else nxt
        dg, _ = mb.decode_fn(params, cache, nxt.to(dev), torch.tensor(len(prompt), device=dev))
    return lg.cpu(), dg.cpu(), nxt.cpu()


def phase_vs_cpu(torch, res, Engine, EngineConfig, Request, bundle, tree_map,
                 bf16_tol=ENGINE_REL_TOL, extras=None, prompt_len: int = 100,
                 max_len: int = 256, ungated=()):
    """The card's bf16 run and the same weights in f32 on the card, each
    against f32 on the CPU (plain versions): the f32 pair shows what the
    port computes, the bf16 pair adds bf16 rounding.  An MoE adds its bf16
    prefill and step with the CPU f32 run's routing: rounding alone,
    without the experts it moves.  ``extras`` (bf16 on the card) go to the
    prefills and the engine's request; the f32 runs take the same values in
    f32.  The free-running bf16 run's readings named in ``ungated``
    ("prefill", "decode") are reported, not gated.  Returns the errors by
    run."""
    mb, params = res["bundle"], res["params"]
    log(f"{mb.cfg.name} on the card vs the same weights in f32 on the CPU:")
    mb32 = bundle(dataclasses.replace(mb.cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float().cpu(), params)
    extras = extras or {}
    prompt = vs_cpu_prompt(mb.cfg.vocab_size, prompt_len)
    n_new, routes, nxt = 24, [], None
    runs = {}  # key -> (prefill logits, decode logits, greedy tokens)
    for key, b_, p_, dev in (("cpu f32", mb32, params32, "cpu"),
                             ("card bf16", mb, params, "cuda"),
                             ("card f32", mb32, tree_map(lambda t: t.cuda(), params32), "cuda")):
        ex = {k: (v if "bf16" in key else v.float()).to(dev) for k, v in extras.items()}
        with moe_routes(routes) if key == "cpu f32" else contextlib.nullcontext():
            lg, dg, nxt = prefill_and_step(torch, b_, p_, prompt, ex, max_len, dev, nxt)
        eng = Engine(b_, p_, EngineConfig(max_slots=2, max_len=max_len))
        eng.submit(Request(rid="g", prompt=prompt, max_new_tokens=n_new, extras=ex))
        runs[key] = (lg, dg, eng.run()[0].tokens)
        del p_, eng
    if mb.cfg.n_experts:
        with moe_routes(routes, replay=True):
            lg, dg, _ = prefill_and_step(torch, mb, params, prompt, extras, max_len, "cuda", nxt)
        runs["card bf16 f32-routed"] = (lg, dg, None)
    lc, dc, tc = runs["cpu f32"]
    out, failed = {}, []
    for key, tol in (("card bf16", bf16_tol), ("card f32", ENGINE_F32_REL_TOL),
                     ("card bf16 f32-routed", ENGINE_REL_TOL)):
        if key not in runs:
            continue
        lg, dg, tg = runs[key]
        for label, got, want in (("prefill", lg, lc), ("decode", dg, dc)):
            err = max_err(got, want)
            scale = float(want.abs().max())
            gated = not (key == "card bf16" and label in ungated)
            log(f"  {key} vs cpu f32 {label} logits: max_abs_err={err:.3e}, "
                f"max|logit|={scale:.3f}, rel={err / scale:.3e} "
                f"{f'tol={tol:g}' if gated else 'reported, not gated'}")
            out[f"{key} {label} rel"] = err / scale
            if gated and err > tol * scale:
                failed.append(f"{key} {label}")
        if tg is None:
            continue
        agree = next((i for i, (a, b) in enumerate(zip(tg, tc)) if a != b), n_new)
        out[f"{key} greedy agree"] = agree
        log(f"  {key} vs cpu f32 greedy tokens agreeing before the first difference: "
            f"{agree} of {n_new}")
    if failed:
        raise AssertionError(f"{mb.cfg.name}: {', '.join(failed)} logits disagree with the CPU")
    return out


def family_extras(torch, cfg, gen):
    """A request's frontend input, bf16 on the card: a VLM's patch
    embeddings or an encoder-decoder's frames (1, frontend_len,
    frontend_dim), seeded; none for a text-only family."""
    name = "patch_embeds" if cfg.frontend == "vit" else "frames" if cfg.enc_dec else None
    if name is None:
        return {}
    x = torch.randn((1, cfg.frontend_len, cfg.frontend_dim), generator=gen, device="cuda")
    return {name: x.to(torch.bfloat16)}


def family_requests(torch, Request, cfg, mix, seed: int = 0):
    """The phase 10 request mix of one family: fixed prompt lengths
    (``lens``) or lengths drawn from [lo, hi), ``max_new_tokens`` from
    [lo, hi), seeded tokens and extras."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lens = mix.get("lens") or [int(rng.integers(*mix["prompt"])) for _ in range(8)]
    reqs = []
    for i, plen in enumerate(lens):
        reqs.append(Request(rid=f"req{i}", prompt=list(map(int, rng.integers(1, cfg.vocab_size,
                                                                              size=plen))),
                            max_new_tokens=int(rng.integers(*mix["new"])),
                            extras=family_extras(torch, cfg, gen)))
    return reqs


def family_expected(cfg, n_prefills: int, n_steps: int) -> dict:
    """Launches per kernel that a family's run of n_prefills prefills and
    n_steps decode steps fixes: one flash per attention layer per prefill
    (an encoder-decoder adds its encoder and cross-attention layers), one
    decode per self-attention layer per step except under MLA (einsums),
    one flash per cross-attention layer per step (Sq = 1)."""
    flash = cfg.n_layers * n_prefills
    decode = 0 if cfg.attention == "mla" else cfg.n_layers * n_steps
    if cfg.enc_dec:
        flash += (cfg.n_encoder_layers + cfg.n_layers) * n_prefills + cfg.n_layers * n_steps
    return {"flash_attention": flash, "flash_attention.tc": flash, "decode_attention": decode,
            "decode_attention_q8": 0, "ssd_scan": 0}


def phase_family_engine(torch, ops, arch: str):
    """One full-width engine run of a family (depth cut as FAMILY_RUNS
    says), bf16 seeded weights; launch counts zeroed just before and read
    just after, and each equal to what the mix fixes."""
    from repro_torch.configs import get_config
    from repro_torch.models import bundle
    from repro_torch.serving import Engine, EngineConfig, Request

    over, slots, max_len, mix = FAMILY_RUNS[arch]
    cfg = dataclasses.replace(get_config(arch), **over)
    log(f"family {arch} at full width, {over or 'whole'}: {slots} slots x {max_len}")
    mb = bundle(cfg)
    params = mb.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = Engine(mb, params, EngineConfig(max_slots=slots, max_len=max_len))
    reqs = family_requests(torch, Request, cfg, mix)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = dict(eng.stats)
    tokens = sum(len(c.tokens) for c in done)
    got = {c.rid: (len(c.tokens), c.finish_reason) for c in done}
    want = {r.rid: (r.max_new_tokens, "length") for r in reqs}
    if got != want:
        raise AssertionError(f"{arch}: completions {got}, expected {want}")
    # every request is admitted at the first step (as many slots as
    # requests), so the longest decides the decode steps
    steps = max(r.max_new_tokens for r in reqs) - 1
    if len(reqs) > slots or st["decode_steps"] != steps or st["prefills"] != len(reqs):
        raise AssertionError(f"{arch}: stats {st}, expected {steps} decode steps")
    for name, n in family_expected(cfg, len(reqs), steps).items():
        require(counts, name, counts.get(name, 0) == n, f"{n} in the {arch} run")
    buckets = sorted({1 << (len(r.prompt) - 1).bit_length() for r in reqs})
    out = {"arch": arch, "cut": over or "whole", "params": mb.param_count(), "slots": slots,
           "max_len": max_len, "prompt_lens": [len(r.prompt) for r in reqs],
           "buckets": buckets, "max_new": [r.max_new_tokens for r in reqs],
           "extras": {k: list(v.shape) for k, v in reqs[0].extras.items()},
           "tokens": tokens, "seconds": seconds, "tok_per_s": tokens / seconds,
           "decode_steps": st["decode_steps"], "prefills": st["prefills"], "launches": counts,
           "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20}
    log(f"  {len(done)} completions, {tokens} tokens in {seconds:.3f}s = "
        f"{tokens / seconds:.1f} tok/s, {st['decode_steps']} decode steps, {st['prefills']} "
        f"prefills (buckets {buckets}), launches {counts}, params {out['params']}, peak "
        f"device memory {out['peak_device_mib']:.0f} MiB")
    del eng, params
    torch.cuda.empty_cache()
    return out


def vs_cpu_case(torch, bundle, arch: str, seed: int = 0):
    """Phase 10's card-vs-CPU inputs of one family: its bundle at the
    FAMILY_VS_CPU cut, bf16 weights on the card from a Generator seeded
    ``seed``, extras from one seeded 7, and the prompt length (300 for a
    VLM, past its 256 patches; else 100)."""
    from repro_torch.configs import get_config

    mb = bundle(dataclasses.replace(get_config(arch), **FAMILY_VS_CPU[arch]))
    params = mb.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    extras = family_extras(torch, mb.cfg, torch.Generator(device="cuda").manual_seed(7))
    return mb, params, extras, 300 if mb.cfg.frontend == "vit" else 100


def phase_families(torch, ops, Engine, EngineConfig, Request, bundle, tree_map):
    """10. The four families beyond dense GQA, Mamba-2 and xLSTM: an engine
    run each at full width (FAMILY_RUNS), then each against f32 on the CPU
    at the FAMILY_VS_CPU cuts.  Returns the summary by arch."""
    t_phase = time.perf_counter()
    runs = {arch: phase_family_engine(torch, ops, arch) for arch in FAMILIES}
    for arch in FAMILIES:
        mb, params, extras, plen = vs_cpu_case(torch, bundle, arch)
        res = {"bundle": mb, "params": params}
        log(f"  cut for the CPU: {FAMILY_VS_CPU[arch]} ({mb.param_count()} params)")
        runs[arch]["vs_cpu"] = phase_vs_cpu(
            torch, res, Engine, EngineConfig, Request, bundle, tree_map, extras=extras,
            prompt_len=plen, max_len=VS_CPU_MAX_LEN,
            ungated=BF16_FREE_RUN_UNGATED.get(arch, ()))
        runs[arch]["vs_cpu"]["cut"] = FAMILY_VS_CPU[arch]
        del res, params
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 10: {seconds:.1f}s (target {FAMILY_PHASE_TARGET_S:.0f} s)")
    return {"seconds": seconds, "target_seconds": FAMILY_PHASE_TARGET_S, "runs": runs}


#: phase 7: replica serving shape (sizing and engines), and the engine steps
#: taken before the placement verbs so that requests are in flight
CLUSTER_SLOTS, CLUSTER_LEN, CLUSTER_ROUNDS = 8, 2048, 4


def draft_requests(Request, vocab_size: int):
    """8 seeded requests for the draft model: prompts of 32-256 tokens,
    16-32 new tokens."""
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(8):
        plen = int(rng.integers(32, 257))
        reqs.append(Request(rid=f"draft{i}",
                            prompt=list(map(int, rng.integers(1, vocab_size, size=plen))),
                            max_new_tokens=int(rng.integers(16, 33))))
    return reqs


def phase_cluster(torch, ops, serve, perf):
    """7. The placement-integrated cluster on the card, planning with
    ``perf`` (phase 8's calibrated PerfModel).

    ``ClusterServer(n_nodes=2, device=H100_80GB)`` sizes "chat"
    (smollm-135m) and "draft" (xlstm-125m) replicas from their footprints at
    (8 slots, 2048 tokens) onto 1g.10gb MIG slices, deploys chat x6 and draft
    x2 (eight slices of two 7-slice nodes), attaches a full-width bf16
    engine on the card to every replica (one seeded set of weights per
    model), submits MIX's 16 requests to chat and 8 seeded ones to draft,
    steps every engine CLUSTER_ROUNDS times, retires two chat replicas,
    compacts (the draft replica alone on the second node moves, its live KV
    cache handed off), reconfigures and pumps to completion.  The placements
    are the server's record: every replica shares the whole card, since
    creating MIG instances takes admin rights and the reference binds
    replicas to no partition either (``mig.mode.current`` is printed for
    information).  Gates: every request completes with its max_new_tokens;
    the state validates with every survivor placed once; flash launches ==
    30 x chat prefills, decode launches == 30 x the chat engines' summed
    decode steps (retired engines included), no int8 decode or SSD launch,
    every flash launch on the tensor cores; the compaction moved a replica
    with requests in flight; compaction and reconfiguration each handed off
    or drained every moved replica whose engine had requests in flight and
    priced every move from its engine's card cache.  Returns the ``cluster``
    summary and the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import H100_80GB
    from repro_torch.models import bundle
    from repro_torch.serving import ClusterServer, Engine, EngineConfig, Request, live_kv_bytes
    from repro_torch.tree import tree_leaves

    log("cluster: smollm-135m chat x6 and xlstm-125m draft x2 on 2 H100-80GB MIG nodes")
    mig = subprocess.run(["nvidia-smi", "--query-gpu=mig.mode.current,memory.total",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"  nvidia-smi mig.mode.current, memory.total (information, not gated): "
        f"{(mig.stdout or mig.stderr).strip()}")
    srv = ClusterServer(n_nodes=2, device=H100_80GB, policy="heuristic", perf=perf)
    if srv.perf is not perf or perf.device_throughput(H100_80GB) != perf.calibration[H100_80GB.name]:
        raise AssertionError("the cluster does not plan with the calibrated PerfModel")
    walls, layouts, nodes = {}, {}, {}

    def verb(label, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[label] = time.perf_counter() - t0
        placed = [pl.wid for g in srv.state.gpus.values() for pl in g.placements]
        if len(placed) != len(set(placed)) or set(placed) != set(srv.replicas):
            raise AssertionError(f"after {label}: placements {sorted(placed)} != "
                                 f"replicas {sorted(srv.replicas)}")
        srv.state.validate()
        layouts[label] = {pl.wid: [gid, pl.index, pl.profile_id]
                          for gid, g in sorted(srv.state.gpus.items()) for pl in g.placements}
        nodes[label] = srv.metrics().n_gpus
        log(f"  {label} ({walls[label]:.3f}s): {nodes[label]} nodes, layout {layouts[label]}")
        return out

    profiles = {}
    for model, arch, n in (("chat", SMOLLM, 6), ("draft", XLSTM, 2)):
        rep = verb(f"deploy {model}", lambda: srv.deploy(
            model, arch, n, max_batch=CLUSTER_SLOTS, max_len=CLUSTER_LEN))
        got = sorted({srv.state.workloads[w].profile_id for w in rep.placed})
        profiles[model] = [H100_80GB.profile(p).name for p in got]
        if rep.pending or len(rep.placed) != n or got != [19]:
            raise AssertionError(f"{model}: placed {rep.placed}, pending {rep.pending}, "
                                 f"profiles {got}; expected {n} x 1g.10gb (19)")
    weights = {}
    for arch in (SMOLLM, XLSTM):
        mb = bundle(get_config(arch))
        weights[arch] = (mb, mb.init(torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    engines = {}
    for wid, (_, arch) in sorted(srv.replicas.items()):
        mb, params = weights[arch]
        engines[wid] = Engine(mb, params, EngineConfig(max_slots=CLUSTER_SLOTS,
                                                       max_len=CLUSTER_LEN))
        srv.attach_engine(wid, engines[wid])
    chat_reqs = serve.make_requests(serve.parse_args(["--arch", SMOLLM] + MIX),
                                    weights[SMOLLM][0].cfg.vocab_size)
    want = {r.rid: r.max_new_tokens for r in chat_reqs}
    draft_reqs = draft_requests(Request, weights[XLSTM][0].cfg.vocab_size)
    want.update({r.rid: r.max_new_tokens for r in draft_reqs})

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_serve = time.perf_counter()
    for r in chat_reqs:
        srv.submit("chat", r)
    for r in draft_reqs:
        srv.submit("draft", r)
    for _ in range(CLUSTER_ROUNDS):
        for eng in srv.engines.values():
            eng.step()
    retired = verb("retire chat x2", lambda: srv.retire("chat", 2))
    busy = sorted(w for w, e in srv.engines.items() if e.has_work)
    cp = verb("compact", srv.compact)
    busy_rc = sorted(w for w, e in srv.engines.items() if e.has_work)
    rc = verb("reconfigure", srv.reconfigure)
    t_pump = time.perf_counter()
    pumped = srv.pump()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = ops.launch_counts()

    done = {c.rid: c for e in engines.values() for c in e.completed}
    if sorted(done) != sorted(want):
        raise AssertionError(f"completed {sorted(done)}, submitted {sorted(want)}")
    for rid, n_new in want.items():
        c = done[rid]
        if c.finish_reason != "length" or len(c.tokens) != n_new:
            raise AssertionError(f"{rid}: {len(c.tokens)} tokens ({c.finish_reason}), "
                                 f"expected {n_new}")
    n_attn = weights[SMOLLM][0].cfg.n_layers
    chat = [e for w, e in engines.items() if w.startswith("chat/")]
    prefills = sum(e.stats["prefills"] for e in chat)
    steps = sum(e.stats["decode_steps"] for e in chat)
    require(counts, "flash_attention", prefills == len(chat_reqs) and
            counts.get("flash_attention", 0) == n_attn * prefills,
            f"{n_attn} x {prefills} chat prefills")
    require(counts, "decode_attention", counts.get("decode_attention", 0) == n_attn * steps,
            f"{n_attn} x {steps} chat decode steps")
    for name in ("decode_attention_q8", "ssd_scan"):
        require(counts, name, counts.get(name, 0) == 0, "0")
    require_tc(counts)

    def executed(label, rep, busy_then):
        """A committed verb's moves: every moved replica whose engine had
        requests in flight was handed off or drained, and the plan priced
        each moved replica as its weights plus its engine's card cache."""
        moves = [dataclasses.asdict(mv) for mv in rep.plan.iter_moves()] if rep.plan else []
        moved = [mv["wid"] for mv in moves if mv["src_gid"] is not None]
        ex = rep.execution
        live = sorted(set(moved) & set(busy_then))
        if rep.committed and moved and not (ex is not None and ex.completed and
                                            set(live) <= set(ex.handoffs) | set(ex.drained)):
            raise AssertionError(f"{label} moved {moved} (busy {busy_then}), committed "
                                 f"{rep.committed}, execution {ex}")
        priced = {w: srv._footprints[w][0] + live_kv_bytes(engines[w].cache) for w in moved}
        on_card = all(t.is_cuda for w in moved for t in tree_leaves(engines[w].cache))
        total = rep.cost.total_bytes if rep.cost else 0
        if total != sum(priced.values()) or not on_card:
            raise AssertionError(f"{label} priced {total} bytes, the moved replicas' "
                                 f"weights + card caches hold {priced}")
        return {"nodes_before": rep.before.n_gpus, "nodes_after": rep.after.n_gpus,
                "moves": moves, "busy": busy_then, "live_moved": live, "bytes_priced": total,
                "priced_by_replica": priced, "committed": rep.committed,
                "handoffs": ex.handoffs if ex else [], "drained": ex.drained if ex else []}

    compact = executed("compaction", cp, busy)
    if not (cp.committed and compact["live_moved"]):
        raise AssertionError(f"compaction committed no move of a replica with requests in "
                             f"flight: {compact}")
    reconfigure = executed("reconfiguration", rc, busy_rc)
    tokens = sum(len(c.tokens) for c in done.values())
    summary = {
        "device_model": H100_80GB.name, "nodes": 2, "policy": "heuristic",
        "fabric_device": str(srv.engine.policy.fabric_device),
        "profiles": profiles, "retired": retired,
        "layouts": layouts, "nodes_used": nodes,
        "compact": compact, "reconfigure": reconfigure,
        "verb_wall_s": walls,
        "requests": len(done), "tokens": tokens,
        "pump_tokens": pumped, "pump_s": t_end - t_pump,
        "pump_tok_per_s": pumped / (t_end - t_pump),
        "serve_s": t_end - t_serve, "serve_tok_per_s": tokens / (t_end - t_serve),
        "chat_prefills": prefills, "chat_decode_steps": steps,
        "draft_decode_steps": sum(e.stats["decode_steps"] for w, e in engines.items()
                                  if w.startswith("draft/")),
        "launches": counts,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "planned_rates_1g10gb": dict(zip(("prefill_tokens_per_s", "decode_tokens_per_s"),
                                         srv.perf.rates(H100_80GB, 19))),
        "planned_parallel_efficiency": srv.perf.parallel_efficiency,
    }
    log(f"  {len(done)} requests, {tokens} tokens in {t_end - t_serve:.3f}s; pump "
        f"{pumped} tokens in {t_end - t_pump:.3f}s = {pumped / (t_end - t_pump):.1f} tok/s; "
        f"launches {counts}")
    return summary, counts


#: phase 9: the placement core at fleet scale on the card
FLEET_SEED = 0
FLEET_SWEEP_GPUS = 4096
FLEET_SWEEP_ROWS = 256  # rows whose feasibility is also held to can_place_at
FLEET_SWEEP_REPS = 10
FLEET_DEPLOY_GPUS = (1024, 4096)
#: fleet sizes the scalar deploys run at: at 4096 GPUs they take over 60 s
#: on the host (first_fit 70.1 s on the H100 machine's host; first_fit 120 s
#: and rule_based 189 s on an 8-core development host), a phase's time on
#: its own, so they are held to the sweeps at 1024 GPUs only
FLEET_SCALAR_GPUS = (1024,)
#: fleet sizes whose deploys are also held to ``metrics.evaluate`` across
#: backends: it costs ~12 s a layout at 4096 GPUs on the host (it looks each
#: workload up across the fleet), where equal layouts and pending lists
#: already fix its values
FLEET_METRICS_GPUS = (1024,)
#: an online trace over 1024 GPUs, with the fleet-scale trace's scaling
#: (arrival rate GPUs / 8 per second, mean lifetime 0.6 x horizon)
FLEET_TRACE_GPUS, FLEET_TRACE_HORIZON = 1024, 8.0
FLEET_TRACE_VERBS = dict(compact_every=3.0, reconfigure_every=5.0)
#: a demand run on 256 nodes: phase 7's chat (smollm-135m, MIX's mean
#: request lengths) and draft pair on 1g.10gb slices.  The rates come from
#: phase 8's PerfModel: chat offers FLEET_DEMAND_CHAT_REPLICAS replicas'
#: worth of load at the autoscaler's target utilization, with an 8x flash
#: crowd for 15 s, draft FLEET_DEMAND_DRAFT_REPLICAS.  This load fills about
#: 1% of the fleet: filling it would take the fleet's capacity, some 450,000
#: requests per simulated second at the calibrated rates, against some
#: 25,000 requests per second of wall time that the event loop replays on
#: the host.  So (d) checks the demand loop on a 256-node mirror and the
#: backends' parity, not the fleet's behaviour under load.
FLEET_DEMAND_NODES, FLEET_DEMAND_HORIZON = 256, 60.0
FLEET_DEMAND_CHAT_REPLICAS, FLEET_DEMAND_DRAFT_REPLICAS = 2.0, 0.5
FLEET_PHASE_TARGET_S = 120.0


def fleet_sweep_counter(fabric):
    """Wrap the fabric's numpy and torch all-profile sweeps and count full
    sweeps per backend: a call over more than one row (the refresh after
    ``apply``/``unapply`` passes its one row, and stays numpy on the host
    whatever the device; it counts under ``numpy_row``).  Returns the
    ``(counts, seconds)`` dicts, keyed alike (seconds on the host clock
    around each call; a torch sweep ends in its copy back to the host)."""
    counts, seconds = {}, {}

    def wrap(name, backend_of):
        real = getattr(fabric, name)

        def counted(occ, *args, **kw):
            key = backend_of(occ) + ("" if occ.shape[0] > 1 else "_row")
            t0 = time.perf_counter()
            out = real(occ, *args, **kw)
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            counts[key] = counts.get(key, 0) + 1
            return out

        setattr(fabric, name, counted)

    for name in ("_feasible_all_np", "_score_all_np"):
        wrap(name, lambda occ: "numpy")
    for name in ("_feasible_all_torch", "_score_all_torch"):
        wrap(name, lambda occ: occ.device.type)
    return counts, seconds


def phase_fleet(torch, perf):
    """9. The placement core at fleet scale, its full sweeps on the card.

    (a) ``generate_test_case(FLEET_SEED, 4096, H100_80GB)``: the torch
    sweep on the card gives the feasibility and both score slabs exactly
    (tolerance 0: bools and int32s) as the numpy sweep does, and on 256
    sampled rows feasibility equals ``GPUState.can_place_at``; one sweep per
    backend is timed (warm median of FLEET_SWEEP_REPS, the card's with
    ``torch.cuda.synchronize``).  (b) Deploys at 1024 and 4096 GPUs:
    first_fit and rule_based through the numpy sweep, ``fabric_device=
    "cuda"`` and (at FLEET_SCALAR_GPUS) the scalar path, frag_aware through
    the two sweeps; every run of a policy lands the same ``wid -> (gid,
    index)`` layout and pending list, with the same ``metrics.evaluate``
    values at FLEET_METRICS_GPUS (at 4096 GPUs equal layouts and pending
    lists fix the metrics).  (c) A frag_aware online trace over 1024 GPUs
    with compaction and reconfiguration, replayed through the card's and
    the numpy sweep: equal ``TraceStats`` (all but the engine's seconds) and
    final layouts.  (d) A ``DemandSimulator`` run on 256 nodes planned with
    ``perf`` (phase 8's PerfModel, which also sets its request rates),
    frag_aware, through both sweeps: equal stats and layouts.  Every card run made at least one full
    sweep on the card and none in numpy; no kernel launched.  Returns the
    ``fleet`` summary."""
    from repro_torch.core import fabric, metrics
    from repro_torch.core.autoscaler import SLO, Autoscaler, AutoscalerConfig
    from repro_torch.core.engine import PlacementEngine
    from repro_torch.core.events import (DemandSimulator, ModelServiceSpec, OnlineSimulator,
                                         build_fleet, generate_trace)
    from repro_torch.core.profiles import H100_80GB
    from repro_torch.core.simulator import generate_test_case
    from repro_torch.core.traffic import ConstantRate, FlashCrowd, ModelTraffic, generate_requests
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    sweeps, sweep_s = fleet_sweep_counter(fabric)
    part_s, t_part = {}, [t_phase]
    ops.reset_launch_counts()

    def part_done(name):
        now = time.perf_counter()
        part_s[name], t_part[0] = now - t_part[0], now

    def layout_of(state):
        return {pl.wid: (gid, pl.index) for gid, g in state.gpus.items() for pl in g.placements}

    def counted(label, card, fn):
        """Run ``fn`` with the sweep counts zeroed; a card run must sweep the
        fleet on the card at least once and never in numpy, a host run never
        on the card.  Returns ``fn``'s result and the run's counts, with the
        seconds spent in the sweeps under ``seconds``."""
        sweeps.clear()
        sweep_s.clear()
        out = fn()
        got = dict(sweeps, seconds=dict(sweep_s))
        full = {k: v for k, v in sweeps.items() if not k.endswith("_row")}
        ok = (full.get("cuda", 0) >= 1 and full.get("numpy", 0) == 0) if card else \
            full.get("cuda", 0) == 0
        if not ok:
            raise AssertionError(f"{label}: full sweeps {got}")
        return out, got

    # (a) the slabs at 4096 GPUs
    log(f"fleet: the placement core on {H100_80GB.name} fleets, full sweeps on the card")
    tc = generate_test_case(FLEET_SEED, n_gpus=FLEET_SWEEP_GPUS, device=H100_80GB)
    state = tc.initial
    fabs = {"numpy": fabric.FleetFabric(state, device=None),
            "cuda": fabric.FleetFabric(state, device="cuda")}
    slabs, slab_sweeps = {}, {}
    for backend, fab in fabs.items():
        def sweep(fab=fab):
            return (fab._sweep_feasible(),) + fab._sweep_scores()
        slabs[backend], slab_sweeps[backend] = counted(f"sweep {backend}", backend == "cuda",
                                                       sweep)
    for name, got, want in zip(("feasible", "waste_delta", "frag_runs_after"), slabs["cuda"],
                               slabs["numpy"]):
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"cuda sweep {name} {got.dtype}{got.shape} != numpy "
                                 f"{want.dtype}{want.shape} (tolerance 0)")
    fab, feas = fabs["numpy"], slabs["cuda"][0]
    rows = sorted(random.Random(FLEET_SEED).sample(range(len(fab.gids)), FLEET_SWEEP_ROWS))
    checked = 0
    for r in rows:
        gpu = state.gpus[fab.gids[r]]
        for p, prof in enumerate(gpu.device.profiles):
            for i in range(fab.M):
                if bool(feas[r, p, i]) != gpu.can_place_at(prof, i):
                    raise AssertionError(f"cuda feasibility {fab.gids[r]} {prof.name} @ {i}")
                checked += 1
    sweep_ms = {}
    for backend, fab in fabs.items():
        for part, fn in (("feasible", fab._sweep_feasible), ("score", fab._sweep_scores)):
            times = []
            for _ in range(FLEET_SWEEP_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            sweep_ms.setdefault(backend, {})[part] = float(np.median(times[1:]))
    sweep = {
        "gpus": FLEET_SWEEP_GPUS, "seed": FLEET_SEED,
        "allocated_gpus": len(state.used_gpus()), "placements": len(state.workloads),
        "slab_shape": list(feas.shape), "equal": True, "tolerance": 0,
        "rows_checked_against_can_place_at": len(rows), "triples_checked": checked,
        "sweeps": slab_sweeps, "ms": sweep_ms, "reps": FLEET_SWEEP_REPS,
    }
    log(f"  (a) {FLEET_SWEEP_GPUS} GPUs, {sweep['allocated_gpus']} allocated: slabs "
        f"{list(feas.shape)} equal; {checked} triples on {len(rows)} rows == can_place_at; "
        f"sweep ms (feasible, score) numpy {sweep_ms['numpy']}, cuda {sweep_ms['cuda']}")
    part_done("a_sweeps")

    # (b) deploys at 1024 and 4096 GPUs
    deploys = {}
    for n in FLEET_DEPLOY_GPUS:
        tc = generate_test_case(FLEET_SEED, n_gpus=n, device=H100_80GB)
        all_wl = list(tc.initial.workloads.values()) + list(tc.new_workloads)
        rows_n = {}
        for policy in ("first_fit", "rule_based", "frag_aware"):
            runs = [("numpy", "on", None), ("cuda", "on", "cuda")]
            if policy != "frag_aware" and n in FLEET_SCALAR_GPUS:
                runs.insert(0, ("scalar", "off", None))
            res, seconds, counts_by_run = {}, {}, {}
            for backend, fab_mode, dev in runs:
                st = tc.initial.clone()
                eng = PlacementEngine(policy, fabric=fab_mode, fabric_device=dev)

                def deploy(eng=eng, st=st):
                    t0 = time.perf_counter()
                    out = eng.deploy(st, tc.new_workloads)
                    return out, time.perf_counter() - t0

                (out, seconds[backend]), counts_by_run[backend] = counted(
                    f"{policy} deploy {n} {backend}", backend == "cuda", deploy)
                st.validate()
                res[backend] = (st, [w.wid for w in out.pending])
            first = runs[0][0]
            base_layout, base_pending = layout_of(res[first][0]), res[first][1]
            evaluated = [b for b, _, _ in runs] if n in FLEET_METRICS_GPUS else []
            t0 = time.perf_counter()
            mets = {b: dataclasses.asdict(metrics.evaluate(res[b][0], tc.initial, all_wl))
                    for b in evaluated}
            eval_s = time.perf_counter() - t0
            for backend, (st, pending) in res.items():
                if layout_of(st) != base_layout or pending != base_pending:
                    raise AssertionError(f"{policy} at {n} GPUs: the {backend} layout differs "
                                         f"from the {first} layout")
                if backend in mets and mets[backend] != mets[first]:
                    raise AssertionError(f"{policy} at {n} GPUs: {backend} metrics "
                                         f"{mets[backend]} != {first} {mets[first]}")
            used = len({gid for gid, _ in base_layout.values()})
            rows_n[policy] = {"runs": [b for b, _, _ in runs], "layouts_equal": True,
                              "metrics_equal": bool(mets), "metrics_evaluated_on": evaluated,
                              "metrics": mets.get(first), "gpus_used": used,
                              "seconds": seconds,
                              "metrics_seconds": eval_s,
                              "sweeps": counts_by_run,
                              "placed": len(base_layout), "pending": len(base_pending)}
            log(f"  (b) {n} GPUs {policy}: {len(base_layout)} placed, {len(base_pending)} "
                f"pending, {used} GPUs used, layouts equal over "
                f"{[b for b, _, _ in runs]}{', metrics equal' if mets else ''}; deploy s "
                + ", ".join(f"{b} {s:.3f}" for b, s in seconds.items()))
        deploys[n] = rows_n
        part_done(f"b_deploys_{n}")
    scalar_note = (f"first_fit and rule_based run the scalar path at {list(FLEET_SCALAR_GPUS)} "
                   f"GPUs only: it takes over 60 s at 4096 on the host")
    log(f"  (b) {scalar_note}")

    # (c) an online trace over 1024 GPUs
    trace_runs = {}
    for backend, dev in (("cuda", "cuda"), ("numpy", None)):
        fleet = build_fleet([(H100_80GB, FLEET_TRACE_GPUS)])
        trace = generate_trace(FLEET_SEED, fleet, horizon=FLEET_TRACE_HORIZON,
                               arrival_rate=FLEET_TRACE_GPUS / 8.0,
                               mean_lifetime=0.6 * FLEET_TRACE_HORIZON)
        sim = OnlineSimulator(fleet, PlacementEngine("frag_aware", fabric_device=dev),
                              **FLEET_TRACE_VERBS)
        t0 = time.perf_counter()
        stats, got = counted(f"trace {backend}", backend == "cuda", lambda: sim.run(trace))
        wall = time.perf_counter() - t0
        fleet.validate()
        d = stats.as_dict()
        trace_runs[backend] = {"stats": d, "layout": layout_of(fleet), "sweeps": got,
                               "wall_s": wall, "engine_seconds": d.pop("engine_seconds"),
                               "arrivals": trace.n_arrivals}
    if trace_runs["cuda"]["stats"] != trace_runs["numpy"]["stats"] or \
            trace_runs["cuda"]["layout"] != trace_runs["numpy"]["layout"]:
        diff = {k: (v, trace_runs["numpy"]["stats"][k])
                for k, v in trace_runs["cuda"]["stats"].items()
                if v != trace_runs["numpy"]["stats"][k]}
        raise AssertionError(f"trace: the cuda and numpy replays differ: {diff}")
    ts = trace_runs["cuda"]["stats"]
    trace_summary = {
        "gpus": FLEET_TRACE_GPUS, "horizon": FLEET_TRACE_HORIZON,
        "arrival_rate": FLEET_TRACE_GPUS / 8.0, "mean_lifetime": 0.6 * FLEET_TRACE_HORIZON,
        "verbs": FLEET_TRACE_VERBS, "policy": "frag_aware",
        "arrivals": trace_runs["cuda"]["arrivals"], "stats_equal": True, "layouts_equal": True,
        "stats": ts,
        "by_backend": {b: {k: r[k] for k in ("sweeps", "wall_s", "engine_seconds")}
                       for b, r in trace_runs.items()},
    }
    log(f"  (c) trace over {FLEET_TRACE_GPUS} GPUs, {trace_summary['arrivals']} arrivals: "
        f"stats and layouts equal; avg GPUs {ts['time_avg_gpus_used']:.2f}, peak "
        f"{ts['peak_gpus_used']}, {ts['n_compactions']} compactions, {ts['n_reconfigures']} "
        f"reconfigures, {ts['n_migrations']} migrations; engine s cuda "
        f"{trace_runs['cuda']['engine_seconds']:.3f}, numpy "
        f"{trace_runs['numpy']['engine_seconds']:.3f}")

    part_done("c_trace")

    # (d) a DemandSimulator run on 256 nodes, planned with phase 8's PerfModel
    slo = SLO(ttft_seconds=0.5, tpot_seconds=0.05)
    scaler_cfg = AutoscalerConfig(up_cooldown=0.0, down_cooldown=10.0)
    shapes = {"chat": (366, 48), "draft": (128, 32)}
    capacity = {m: perf.capacity_rps(H100_80GB, 19, *shape) for m, shape in shapes.items()}
    rates = {m: n * scaler_cfg.target_utilization * capacity[m]
             for m, n in (("chat", FLEET_DEMAND_CHAT_REPLICAS),
                          ("draft", FLEET_DEMAND_DRAFT_REPLICAS))}
    demand_runs = {}
    for backend, dev in (("cuda", "cuda"), ("numpy", None)):
        traffic = generate_requests(
            [ModelTraffic("chat", FlashCrowd(rates["chat"], flash_at=20.0, flash_duration=15.0,
                                             multiplier=8.0),
                          mean_prompt_len=shapes["chat"][0], mean_decode_len=shapes["chat"][1]),
             ModelTraffic("draft", ConstantRate(rates["draft"]),
                          mean_prompt_len=shapes["draft"][0],
                          mean_decode_len=shapes["draft"][1])],
            seed=FLEET_SEED, horizon=FLEET_DEMAND_HORIZON)
        fleet = build_fleet([(H100_80GB, FLEET_DEMAND_NODES)])
        specs = [ModelServiceSpec("chat", 19, slo=slo, initial_replicas=6),
                 ModelServiceSpec("draft", 19, slo=slo, initial_replicas=2)]
        sim = DemandSimulator(
            fleet, PlacementEngine("frag_aware", fabric_device=dev), specs,
            autoscaler=Autoscaler(scaler_cfg), perf=perf, compact_every=15.0)
        if sim.perf is not perf:
            raise AssertionError("the demand run does not plan with the calibrated PerfModel")
        t0 = time.perf_counter()
        stats, got = counted(f"demand {backend}", backend == "cuda", lambda: sim.run(traffic))
        wall = time.perf_counter() - t0
        fleet.validate()
        d = stats.as_dict()
        demand_runs[backend] = {"stats": d, "layout": layout_of(fleet), "sweeps": got,
                                "wall_s": wall, "engine_seconds": d.pop("engine_seconds")}
    if demand_runs["cuda"]["stats"] != demand_runs["numpy"]["stats"] or \
            demand_runs["cuda"]["layout"] != demand_runs["numpy"]["layout"]:
        raise AssertionError("demand: the cuda and numpy runs differ")
    ds = demand_runs["cuda"]["stats"]
    if ds["n_requests"] == 0 or ds["n_completed"] + ds["n_unserved"] != ds["n_requests"]:
        raise AssertionError(f"demand: requests not accounted: {ds}")
    demand = {
        "nodes": FLEET_DEMAND_NODES, "horizon": FLEET_DEMAND_HORIZON, "policy": "frag_aware",
        "slo": dataclasses.asdict(slo), "stats_equal": True, "layouts_equal": True,
        "planned_rates_1g10gb": dict(zip(("prefill_tokens_per_s", "decode_tokens_per_s"),
                                         perf.rates(H100_80GB, 19))),
        "replica_capacity_rps": capacity, "offered_rps": rates,
        "offered_replicas": {"chat": FLEET_DEMAND_CHAT_REPLICAS,
                             "draft": FLEET_DEMAND_DRAFT_REPLICAS},
        "flash_multiplier": 8.0,
        "peak_fleet_share": ds["peak_gpus_used"] / FLEET_DEMAND_NODES,
        "checks": "the demand loop and backend parity; the load fills about 1% of the fleet",
        "slo_attainment": ds["slo_attainment"],
        "slo_attainment_by_model": ds["slo_attainment_by_model"],
        "time_avg_gpus_used": ds["time_avg_gpus_used"],
        "time_avg_compute_waste": ds["time_avg_compute_waste"],
        "time_avg_memory_waste": ds["time_avg_memory_waste"],
        "scale_decisions": {k: ds[k] for k in ("n_scale_ups", "n_scale_downs", "n_resizes",
                                               "n_deploy_rejected")},
        "stats": ds,
        "by_backend": {b: {k: r[k] for k in ("sweeps", "wall_s", "engine_seconds")}
                       for b, r in demand_runs.items()},
    }
    log(f"  (d) demand on {FLEET_DEMAND_NODES} nodes (chat {rates['chat']:.1f}/s, 8x for 15 s, "
        f"draft {rates['draft']:.1f}/s from the PerfModel; peak {ds['peak_gpus_used']} GPUs, "
        f"{demand['peak_fleet_share']:.2%} of the fleet): {ds['n_requests']} requests, SLO "
        f"attainment {ds['slo_attainment']:.4f}, avg GPUs {ds['time_avg_gpus_used']:.3f}, "
        f"compute waste {ds['time_avg_compute_waste']:.3f}, scale decisions "
        f"{demand['scale_decisions']}; stats and layouts equal")

    part_done("d_demand")
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 9 launched kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 9: {seconds:.1f}s (target {FLEET_PHASE_TARGET_S:.0f} s), by part "
        + ", ".join(f"{k} {v:.1f}s" for k, v in part_s.items()))
    return {"device_model": H100_80GB.name, "seconds": seconds, "part_seconds": part_s,
            "target_seconds": FLEET_PHASE_TARGET_S, "sweep": sweep, "deploys": deploys,
            "scalar": scalar_note, "trace": trace_summary, "demand": demand,
            "kernel_launches": launches}


#: phase 8: the profiles a sweep of the H100 80GB measures (distinct compute
#: and memory footprints, biggest first) and the preset it runs
CAL_LADDER, CAL_PRESET = [0, 5, 9, 14, 15, 19], "full"


def calibration_formulas(kernel: str, shape: dict, b: int):
    """(tokens, flops, bytes) of one calibration row at batch ``b``: the
    reference profiler's formulas, f32 inputs (4 bytes per element)."""
    if kernel == "flash_attention":
        s, hq, hkv, d = shape["s"], shape["hq"], shape["hkv"], shape["d"]
        return (b * s, 4 * b * s * s * hq * d / 2,
                4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d))
    if kernel == "decode_attention":
        smax, hq, hkv, d = shape["smax"], shape["hq"], shape["hkv"], shape["d"]
        return (b, 4.0 * b * smax * hq * d,
                4.0 * (2 * b * hq * d + 2 * b * smax * hkv * d) + 4.0 * b)
    s, h, p, n = shape["s"], shape["h"], shape["p"], shape["n"]
    return (b * s, 2.0 * b * s * h * p * n * 2,
            4.0 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + b * h * p * n))


def time_calibration_shape(torch, F, wl, plain, launches: int) -> dict:
    """One calibration workload at its whole-device shape (f32, as the
    profiler runs it): ms, device_ms, plain_ms, library_ms (SDPA for the
    attention kernels) and the bound against the float32 peak, of the work
    ``kernels.cost`` counts on these inputs (decode: the rows up to each
    length)."""
    from repro_torch.kernels import cost

    cuda = torch.device("cuda")
    fn, args = wl.make(cuda)
    n_sets = copies_past_l2(sum(a.numel() * a.element_size() for a in args))
    sets = [args] + [wl.make(cuda)[1] for _ in range(n_sets - 1)]
    library, names = None, ()
    if wl.kernel == "flash_attention":
        names = ("fa_fwd_kernel", "fa_tc_kernel")
        work = cost.flash_attention(*args, True)

        def library(q, k, v):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=True, enable_gqa=True)
    elif wl.kernel == "decode_attention":
        smax = args[1].shape[1]
        names = ("decode_split_kernel", "decode_combine_kernel")
        work = cost.decode_attention(*args[:3], lengths=args[3].tolist())
        mask = (torch.arange(smax, device=cuda)[None, :] < args[3][:, None])[:, None, None, :]

        def library(q, k, v, lens):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask, enable_gqa=True)
    else:
        names = ("ssd_kernel<", "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                 "ssd_chunk_scan_kernel")
        work = cost.ssd_scan(*args)
    out = dict(shape=f"{wl.shape} float32", launches=launches,
               ms=time_ms(fn, sets), plain_ms=time_ms(plain, sets, iters=5),
               library_ms=None if library is None else time_ms(library, sets),
               **device_times(fn, names, library, sets), **bound(*work, F32_FLOPS))
    del sets, args
    return out


def phase_calibration(torch, F, ops, ref):
    """8. Calibrate the H100 80GB's MIG ladder through the kernels.

    ``run_calibration([H100_80GB], preset="full", emulate=True)`` on the
    card, launch counts zeroed just before and read just after: flash,
    decode and the SSD scan each 6 profiles x (3 warm-up + 10 timed) calls,
    the flash and SSD calls through their CUDA-core bodies (f32), no int8
    decode.  Then each kernel at the preset's whole-device shape against its
    plain version (f32 tolerances), the artifact's structure and every
    row's tokens, FLOPs and bytes against the formulas, and the PerfModel
    loaded from it: monotone over the ladder, 0 < parallel_efficiency <= 1.
    Each kernel's whole-device call is also timed as phase 6 times the
    serving shapes (``time_calibration_shape``).  Returns the
    ``calibration`` summary, the launch counts, the PerfModel and the
    timings by kernel."""
    from repro_torch.core.perfmodel import PerfModel
    from repro_torch.core.profiles import H100_80GB
    from repro_torch.obs import profile

    log(f"calibration: {H100_80GB.name} MIG ladder, preset {CAL_PRESET}, emulated slices "
        f"(MIG is off), f32")
    cfg = profile.PRESETS[CAL_PRESET]
    calls = len(CAL_LADDER) * (cfg["warmup"] + cfg["reps"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = profile.run_calibration([H100_80GB], preset=CAL_PRESET, emulate=True, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {"flash_attention": calls, "flash_attention.simt": calls, "decode_attention": calls,
            "ssd_scan": calls, "ssd_scan.simt": calls, "flash_attention.tc": 0, "ssd_scan.tc": 0,
            "decode_attention_q8": 0}
    for name, n in want.items():
        require(counts, name, counts.get(name, 0) == n, f"{n} in the calibration run")
    bodies = {"flash_attention": "simt (fa_fwd_kernel)", "ssd_scan": "simt (ssd_kernel)",
              "decode_attention": "decode_split_kernel + decode_combine_kernel"}
    log(f"  {seconds:.2f}s, launches {counts}")

    # each kernel once at the whole-device shape, against its plain version
    plain = {"flash_attention": lambda q, k, v: ref.attention_ref(q, k, v, True),
             "decode_attention": ref.decode_attention_ref, "ssd_scan": ref.ssd_scan_ref}
    errs, times = {}, {}
    for wl in profile.whole_device_specs(CAL_PRESET):
        fn, args = wl.make(torch.device("cuda"))
        got, wanted = fn(*args), plain[wl.kernel](*args)
        torch.cuda.synchronize()
        tols = SSD_TOL if wl.kernel == "ssd_scan" else TOL
        pairs = zip(("y", "hT"), got, wanted) if isinstance(got, tuple) else [("out", got, wanted)]
        errs[wl.kernel] = max(check_close(f"{wl.kernel} {out} {wl.shape} float32 (calibration)",
                                          g, w, "float32", tols) for out, g, w in pairs)
        del fn, args, got, wanted
        times[wl.kernel] = dict(time_calibration_shape(torch, F, wl, plain[wl.kernel],
                                                       counts[wl.kernel]),
                                max_abs_err=errs[wl.kernel])

    # the artifact: structure, rows against the formulas, the PerfModel
    if set(report) != {"config", "host", "devices", "kernels"} or \
            list(report["devices"]) != [H100_80GB.name]:
        raise AssertionError(f"calibration report sections {sorted(report)}, devices "
                             f"{list(report['devices'])}")
    entry = report["devices"][H100_80GB.name]
    if list(entry["profiles"]) != [str(p) for p in CAL_LADDER] or entry["emulated"] is not True:
        raise AssertionError(f"calibration profiles {list(entry['profiles'])}, emulated "
                             f"{entry['emulated']}")
    if report["config"]["impl"] != "cuda" or len(report["kernels"]) != 3 * len(CAL_LADDER):
        raise AssertionError(f"calibration impl {report['config']['impl']}, "
                             f"{len(report['kernels'])} rows")
    shapes = {"flash_attention": ("flash", "compute_frac"),
              "decode_attention": ("decode", "memory_frac"), "ssd_scan": ("ssd", "compute_frac")}
    rows = []
    for r in report["kernels"]:
        key, frac = shapes[r["kernel"]]
        b = max(1, round(cfg[key]["b"] * r[frac]))
        if (r["tokens"], r["flops"], r["bytes"]) != calibration_formulas(r["kernel"], cfg[key], b) \
                or not r["wall_s"]["p50"] > 0 or r["wall_s"]["reps"] != cfg["reps"]:
            raise AssertionError(f"calibration row {r}")
        rows.append({k: r[k] for k in ("kernel", "profile_id", "profile", "shape", "tokens_per_s",
                                       "achieved_gbytes_per_s", "achieved_gflops_per_s")}
                    | {"p50_s": r["wall_s"]["p50"], "p95_s": r["wall_s"]["p95"]})
    pm = PerfModel.from_calibration(report)
    rates = [pm.rates(H100_80GB, pid) for pid in CAL_LADDER]
    if not 0.0 < pm.parallel_efficiency <= 1.0 or any(
            pb < ps or db < ds for (pb, db), (ps, ds) in zip(rates, rates[1:])):
        raise AssertionError(f"calibrated PerfModel: efficiency {pm.parallel_efficiency}, "
                             f"rates over {CAL_LADDER} {rates}")
    whole = entry["whole_device"]
    log(f"  whole device: prefill {whole['prefill_tokens_per_s']:.1f} tok/s, decode "
        f"{whole['decode_tokens_per_s']:.1f} tok/s, parallel_efficiency "
        f"{entry['parallel_efficiency']:.4f}")
    for pid, p in entry["profiles"].items():
        log(f"  {p['name']:>8} (id {pid:>2}): prefill {p['prefill_tokens_per_s']:.1f} tok/s, "
            f"decode {p['decode_tokens_per_s']:.1f} tok/s")
    summary = {
        "device_model": H100_80GB.name, "preset": CAL_PRESET, "emulated": True,
        "dtype": "float32", "seconds": seconds,
        "whole_device": whole, "parallel_efficiency": entry["parallel_efficiency"],
        "profiles": entry["profiles"],
        "perfmodel_rates": {str(pid): list(r) for pid, r in zip(CAL_LADDER, rates)},
        "rows": rows, "bodies": bodies, "max_abs_err": errs,
        "host_contended": report["host"]["contended"], "launches": counts,
    }
    return summary, counts, pm, times


def bound(flops: int, nbytes: int, peak: float = BF16_FLOPS) -> dict:
    """The least time of a launch: its bytes over the HBM rate or its
    operations over ``peak``, whichever is longer; ``bound(*work)`` for a
    ``kernels.cost.Work``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_times(kernel, names, library, sets) -> dict:
    """device_ms of a kernel's wrapper (its own device kernels, by name) and,
    where one PyTorch call computes the same function, library_device_ms
    (every device kernel that call launches)."""
    dev, src, by_kernel = device_ms(kernel, sets, names)
    out = dict(device_ms=dev, device_ms_source=src, device_kernels=sorted(by_kernel),
               device_ms_by_kernel=by_kernel, library_device_ms=None)
    if library is not None:
        ldev, _, lby = device_ms(library, sets)
        out.update(library_device_ms=ldev, library_device_kernels=sorted(lby))
    return out


def check_rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: cudaError_t {rc}")


def simt_times(fn, names, want, sets) -> dict:
    """The CUDA-core body at a shape that selects the tensor cores, called
    through its library directly (no launch count): its error against the
    plain version and its device time, for the kernel table's older rows."""
    dev, _, _ = device_ms(fn, sets, names)
    return dict(simt_max_abs_err=max_err(fn(*sets[0]), want), simt_device_ms=dev)


def time_flash(torch, F, ref, fa, _build, gen, s, hq, hkv, d=64, b=1):
    """flash_attention on bf16 q (b,s,hq,d), k/v (b,s,hkv,d), causal."""
    from repro_torch.kernels import cost

    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    work = cost.flash_attention(*(torch.empty(x, dtype=torch.bfloat16, device="meta")
                                  for x in shapes), True)
    sets = [tuple(torch.randn(x, generator=gen, device="cuda").to(torch.bfloat16)
                  for x in shapes) for _ in range(copies_past_l2(work.bytes))]
    q, k, v = sets[0]

    def kernel(q, k, v):
        return fa.flash_attention_cuda(q, k, v, True)

    def library(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True, enable_gqa=True)

    def simt(q, k, v):  # the CUDA-core body the shape does not select, for the record
        o = torch.empty_like(q)
        check_rc(_build.load(fa.NAME, fa._SIGNATURES).flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, b, s, s, hq, hkv, d, d, 1,
            0, 1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream))
        return o

    return dict(
        shape=f"q({b},{s},{hq},{d}) kv({b},{s},{hkv},{d}) bf16 causal",
        body=fa.body(q, k, v),
        **simt_times(simt, ("fa_fwd_kernel",), ref.attention_ref(q, k, v, True), sets),
        max_abs_err=max_err(kernel(q, k, v), ref.attention_ref(q, k, v, True)),
        ms=time_ms(kernel, sets),
        plain_ms=time_ms(lambda q, k, v: ref.attention_ref(q, k, v, True), sets),
        library_ms=time_ms(library, sets),
        **device_times(kernel, ("fa_tc_kernel", "fa_fwd_kernel"), library, sets),
        **bound(*work),
    )


def time_decode(torch, F, ref, dec, gen, lens, hq, hkv, d=64, smax=2048):
    """decode_attention on bf16 q (B,1,hq,d) against a (B,smax,hkv,d) cache
    at per-slot lengths ``lens``; bytes count only the rows up to each length
    (a ring's length runs past Smax: its rows stop there)."""
    from repro_torch.kernels import cost

    bsz = len(lens)
    shapes = ((bsz, 1, hq, d), (bsz, smax, hkv, d), (bsz, smax, hkv, d))
    work = cost.decode_attention(*(torch.empty(x, dtype=torch.bfloat16, device="meta")
                                   for x in shapes), lengths=lens)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(smax, device="cuda")[None, :] < length[:, None])[:, None, None, :]
    sets = [tuple(torch.randn(x, generator=gen, device="cuda").to(torch.bfloat16) for x in shapes)
            for _ in range(copies_past_l2(bsz * smax * hkv * d * 2 * 2))]
    q, k, v = sets[0]

    def kernel(q, k, v):
        return dec.decode_attention_cuda(q, k, v, length)

    def library(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask, enable_gqa=True)

    return dict(
        shape=f"q({bsz},1,{hq},{d}) cache({bsz},{smax},{hkv},{d}) bf16 lengths {lens}",
        split=dec.SPLIT,
        max_abs_err=max_err(kernel(q, k, v), ref.decode_attention_ref(q, k, v, length)),
        ms=time_ms(kernel, sets),
        plain_ms=time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, length), sets),
        library_ms=time_ms(library, sets),
        **device_times(kernel, ("decode_split_kernel", "decode_combine_kernel"), library, sets),
        **bound(*work),
    )


def time_flash_case(torch, F, ref, fa, gen, b, sq, sk, hq, hkv, d, dv, causal, window):
    """flash_attention on bf16 q (b,sq,hq,d), k (b,sk,hkv,d), v (b,sk,hkv,dv)
    at one of phase 10's shapes.  Operations count the (query, key) pairs
    the mask leaves (end-aligned causal mask, window); the library call is
    SDPA with that mask."""
    from repro_torch.kernels import cost

    shapes = ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv))
    work = cost.flash_attention(*(torch.empty(x, dtype=torch.bfloat16, device="meta")
                                  for x in shapes), causal, window)
    sets = [tuple(torch.randn(x, generator=gen, device="cuda").to(torch.bfloat16)
                  for x in shapes) for _ in range(copies_past_l2(work.bytes))]
    qpos = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    plain_iters = 30 if b * hq * sq * sk < 2**28 else 5  # the plain version materializes scores
    q, k, v = sets[0]

    def kernel(q, k, v):
        return fa.flash_attention_cuda(q, k, v, causal, window)

    def plain(q, k, v):
        return ref.attention_ref(q, k, v, causal, window)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True,
            **({"is_causal": True} if causal and not window and sq == sk else
               {"attn_mask": mask} if causal or window else {}))

    return dict(
        shape=f"q({b},{sq},{hq},{d}) k({b},{sk},{hkv},{d}) v({b},{sk},{hkv},{dv}) bf16 "
              f"{'causal' if causal else 'non-causal'}{f' window {window}' if window else ''}",
        body=fa.body(q, k, v),
        max_abs_err=max_err(kernel(q, k, v), plain(q, k, v)),
        ms=time_ms(kernel, sets), plain_ms=time_ms(plain, sets, iters=plain_iters),
        library_ms=time_ms(library, sets),
        **device_times(kernel, ("fa_tc_kernel", "fa_fwd_kernel"), library, sets),
        **bound(*work),
    )


def family_kernel_times(torch, F, ref, fa, dec, families):
    """Phase 6's kernels line, extended by phase 10: flash and the bf16
    decode at the shapes each family's engine run gave them
    (family_kernel_shapes of its config as FAMILY_RUNS cuts it), with that
    run's launches.  Prefill at the run's largest bucket, and also at the
    window where a smaller bucket reaches it; decode at each request's
    mid-generation length."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(3)
    flash, decode = {}, {}
    for arch, run in families["runs"].items():
        over, slots, max_len, _ = FAMILY_RUNS[arch]
        cfg = dataclasses.replace(get_config(arch), **over)
        top = max(run["buckets"])
        seq_lens = sorted({top, min(top, cfg.sliding_window or top)})
        lens = [n + m // 2 for n, m in zip(run["prompt_lens"], run["max_new"])]
        cases, dcases = family_kernel_shapes(cfg, slots, max_len, seq_lens, lens)
        flash[arch] = dict(launches=run["launches"].get("flash_attention", 0),
                           shapes=[time_flash_case(torch, F, ref, fa, gen, *c) for c in cases])
        if dcases:
            decode[arch] = dict(launches=run["launches"].get("decode_attention", 0),
                                shapes=[time_decode(torch, F, ref, dec, gen, *c) for c in dcases])
        torch.cuda.empty_cache()
    return flash, decode


def time_ssd_case(torch, ref, _build, ssd, gen, b, s, h, p, n, simt: bool = True) -> dict:
    """ssd_scan on bf16 x (b,s,h,p), B/C (b,s,n), f32 dt, A and a zero
    initial state: the kernel against its plain version, their times, the
    device time and the bound; with ``simt``, the CUDA-core body at the same
    shape too."""
    from repro_torch.kernels import cost

    meta = [torch.empty(x, dtype=dt, device="meta") for x, dt in (
        ((b, s, h, p), torch.bfloat16), ((b, s, h), torch.float32), ((h,), torch.float32),
        ((b, s, n), torch.bfloat16), ((b, s, n), torch.bfloat16),
        ((b, h, p, n), torch.float32))]
    work = cost.ssd_scan(*meta)  # x, y; dt; A; B, C; h0, hT
    n_sets = copies_past_l2(work.bytes)
    sets = [ssd_inputs(torch, gen, torch.bfloat16, b, s, h, p, n)
            + (torch.zeros((b, h, p, n), device="cuda"),) for _ in range(n_sets)]
    y, hT = ssd.ssd_scan_cuda(*sets[0])
    wy, wh = ref.ssd_scan_ref(*sets[0])

    def ssd_simt(x, dt, A, Bm, Cm, h0):  # the CUDA-core body the shape does not select
        yo, ho = torch.empty_like(x), torch.empty_like(h0)
        check_rc(_build.load(ssd.NAME, ssd._SIGNATURES).ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            h0.data_ptr(), yo.data_ptr(), ho.data_ptr(), 1, b, s, h, p, n, x.stride(0),
            x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            torch.cuda.current_stream().cuda_stream))
        return yo
    out = dict(
        shape=f"x({b},{s},{h},{p}) bf16, B/C({b},{s},{n}) bf16, dt f32, h0 zeros f32",
        max_abs_err=max(max_err(y, wy), max_err(hT, wh)),
        ms=time_ms(lambda *a: ssd.ssd_scan_cuda(*a), sets),
        plain_ms=time_ms(lambda *a: ref.ssd_scan_ref(*a), sets, iters=3),
        library_ms=None,  # no single PyTorch call computes a selective scan
        body=ssd.body(*sets[0][:1], *sets[0][3:5]),
        **(simt_times(ssd_simt, ("ssd_kernel<",), wy, sets) if simt else {}),
        **device_times(lambda *a: ssd.ssd_scan_cuda(*a),
                       ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel",
                        "ssd_kernel"), None, sets),
        **bound(*work),
    )
    del sets
    return out


def phase_timing(torch, F, ref, _build, fa, dec, q8, ssd, runs):
    """Each kernel at its serving path's shapes.  The attention kernels run on
    two paths with different head layouts, so their entries also carry the
    zamba2-1.2b shapes (``zamba2``, with that run's launches)."""
    from repro_torch.kernels import cost

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    entries = []
    _, counts, reqs = runs[SMOLLM]
    zres, z_counts, z_reqs = runs[ZAMBA2]
    zcfg = zres["bundle"].cfg
    by_path = {k: {n: c.get(n, 0) for n in KERNELS} for k, (_, c, _) in runs.items()}
    hq, hkv, d = 9, 3, 64
    z_heads = (zcfg.n_heads, zcfg.n_kv_heads, zcfg.head_dim_)

    # --- flash attention at the largest prefill of each path: smollm's
    # power-of-two bucket, zamba2's exact length (recurrent archs are not padded)
    s = max(1 << (len(r.prompt) - 1).bit_length() for r in reqs)
    entries.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:90",
        launches=counts.get("flash_attention", 0), launches_path=SMOLLM,
        **time_flash(torch, F, ref, fa, _build, gen, s, hq, hkv, d),
        zamba2=dict(launches=z_counts.get("flash_attention", 0),
                    **time_flash(torch, F, ref, fa, _build, gen, max(len(r.prompt) for r in z_reqs),
                                 *z_heads)),
    ))

    # --- decode attention: 8 slots mid-generation of the run's requests ----
    bsz, smax = 8, 2048
    lens = [len(r.prompt) + r.max_new_tokens // 2 for r in reqs[:bsz]]
    z_lens = [len(r.prompt) + r.max_new_tokens // 2 for r in z_reqs[:bsz]]
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    entries.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:71",
        launches=counts.get("decode_attention", 0), launches_path=SMOLLM,
        **time_decode(torch, F, ref, dec, gen, lens, hq, hkv, d, smax),
        zamba2=dict(launches=z_counts.get("decode_attention", 0),
                    **time_decode(torch, F, ref, dec, gen, z_lens, *z_heads, smax)),
    ))

    # --- int8 decode attention: the same 8 slots over an int8 cache ---------
    _, q8_counts, _ = runs[INT8]
    n_sets = copies_past_l2(bsz * smax * hkv * (d * 2 + 8))

    def q8_set():
        kq, ks = ref.quantize_kv(torch.randn((bsz, smax, hkv, d), generator=gen, device="cuda"))
        vq, vs = ref.quantize_kv(torch.randn((bsz, smax, hkv, d), generator=gen, device="cuda"))
        return (torch.randn((bsz, 1, hq, d), generator=gen, device="cuda").to(bf), kq, ks, vq, vs)

    sets = [q8_set() for _ in range(n_sets)]
    q8_work = cost.decode_attention_q8(*sets[0], lengths=lens)  # int8 rows + f32 scales
    entries.append(dict(
        name="decode_attention_q8", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention_q8.cu",
        replaces="src/repro/kernels/decode_attention.py:171",
        shape=f"q({bsz},1,{hq},{d}) bf16, int8 cache({bsz},{smax},{hkv},{d}) + f32 scales, "
              f"lengths {lens}",
        launches=q8_counts.get("decode_attention_q8", 0), launches_path=INT8, split=q8.SPLIT,
        max_abs_err=max_err(q8.decode_attention_q8_cuda(*sets[0], length),
                            ref.decode_attention_q8_ref(*sets[0], length)),
        ms=time_ms(lambda *a: q8.decode_attention_q8_cuda(*a, length), sets),
        plain_ms=time_ms(lambda *a: ref.decode_attention_q8_ref(*a, length), sets),
        library_ms=None,  # no single PyTorch call computes attention over an int8 cache
        **device_times(lambda *a: q8.decode_attention_q8_cuda(*a, length),
                       ("decode_q8_split_kernel", "decode_combine_kernel"), None, sets),
        **bound(*q8_work),
    ))
    del sets

    # --- SSD scan at the longest zamba2 prefill of the run ------------------
    h, p, n = zcfg.ssm_heads, zcfg.ssm_expand * zcfg.d_model // zcfg.ssm_heads, zcfg.ssm_state
    s = max(len(r.prompt) for r in z_reqs)  # recurrent prefills run at their exact length
    entries.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:81",
        launches=z_counts.get("ssd_scan", 0), launches_path=ZAMBA2,
        **time_ssd_case(torch, ref, _build, ssd, gen, 1, s, h, p, n),
    ))

    # the int8 decode reads about half the bf16 decode's bytes at the same lengths
    entries[2]["device_ms_vs_bf16_decode"] = entries[2]["device_ms"] / entries[1]["device_ms"]
    for e in entries:
        e["launches_by_path"] = {k: v[e["name"]] for k, v in by_path.items()}
        e["kernel_ms"] = e["ms"]
    return entries


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------
#: (a) the autograd Functions at the training paths' shapes: label ->
#: (b, sq, sk, hq, hkv, d, dv, causal, window).  smollm-135m's step (batch 8
#: x 512), zamba2-1.2b's shared attention block, Mixtral's heads under a
#: window of 128, DeepSeek-V3's MLA (D 192 = nope 128 + rope 64, Dv 128)
TRAIN_FLASH_CASES = {
    SMOLLM: (8, 512, 512, 9, 3, 64, 64, True, None),
    "zamba2-1.2b shared attention": (2, 512, 512, 32, 32, 64, 64, True, None),
    "windowed (Mixtral heads)": (1, 512, 512, 32, 8, 128, 128, True, 128),
    "MLA (DeepSeek-V3)": (1, 512, 512, 128, 128, 192, 128, True, None),
}
#: the SSD scan at zamba2-1.2b's training shape: (b, s, h, p, n)
TRAIN_SSD_CASE = (2, 512, 32, 128, 64)
#: f32 Function vs plain autograd: max error over the largest magnitude of
#: each output and gradient.  The forward kernel and the plain forward sum
#: in other orders (~1e-6), and the backward is plain in both
TRAIN_F32_REL = 1e-4
#: (b) smollm-135m at full width and depth, bf16, through launch/train.py's
#: loop: batch 8 x 512, the launcher's default 100 steps at its default lr
#: of 3e-4 (AdamW's 100-step warmup).  At the full vocabulary of 49152 the
#: loss starts at ln V plus half the random logits' variance (~10.91) and
#: the first tens of steps move it by ~0.03 against a step-to-step noise of
#: ~0.01; in 20 or 40 steps at lr 6e-3 to 3e-2 it rose (the chip runs
#: in PERF.md), so the run is long enough for the first and last tenths'
#: means (10 steps each) to tell a fall from noise
TRAIN_ARGS = ["--arch", SMOLLM, "--steps", "100", "--batch", "8", "--seq", "512",
              "--log-every", "10", "--device", "cuda"]
#: (b) also times zamba2-1.2b's training step at full width, depth cut to 6
#: Mamba-2 layers and one application of the shared block, bf16, batch
#: 2 x 512, remat: (overrides, batch, seq, steps)
TRAIN_ZAMBA2 = (dict(n_layers=6, shared_attn_every=6), 2, 512, 5)
#: (c) card vs CPU on one fixed batch, f32, the same weights: arch ->
#: (config overrides, batch, seq).  smollm-135m cut to 4 of 30 layers;
#: zamba2-1.2b to 2 Mamba-2 layers and one application of the shared block
TRAIN_VS_CPU = {
    SMOLLM: (dict(n_layers=4), 2, 256),
    ZAMBA2: (dict(n_layers=2, shared_attn_every=2), 2, 256),
}
#: card f32 vs CPU f32 limits of (c) and (d): loss (relative), the gradients'
#: global norm (relative) and each gradient leaf's max error over its max;
#: the card's bf16 loss of the same step against its f32 loss
TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_LEAF_REL, TRAIN_BF16_REL = 1e-4, 1e-3, 1e-3, 2e-2
TRAIN_PHASE_TARGET_S = 150.0


def rel_err(got, want) -> float:
    return max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def check_grad_pair(label: str, got, want, dtype_name: str) -> float:
    """One output or gradient of a Function against the plain version's
    autograd in f32 on the same values: f32 within TRAIN_F32_REL of the
    largest magnitude, bf16 within FAMILY_ROW_TOL row-scaled
    (row_scaled_err, which forgives the rounding to bf16)."""
    if dtype_name == "float32":
        r, tol, kind = rel_err(got, want), TRAIN_F32_REL, "rel"
    else:
        r, tol, kind = row_scaled_err(got, want), FAMILY_ROW_TOL, "row-scaled"
    log(f"    {label}: max_abs_err={max_err(got, want):.3e} {kind}={r:.3e} tol={tol:g} "
        f"{'ok' if r <= tol else 'FAIL'}")
    if not r <= tol:
        raise AssertionError(f"{label}: the autograd Function disagrees with plain autograd")
    return r


def grad_leaves(torch, tensors):
    """f32 copies of ``tensors`` (the same values) that require grad."""
    return [t.detach().float().requires_grad_() for t in tensors]


def autograd_flash_case(torch, ops, ref, fa, gen, label, dtype, case):
    """ops.flash_attention under autograd (FlashAttention: the kernel
    forward, counted once under its body; the plain chunked backward) against
    attention_ref's autograd in f32 on the same values; the forward kernel's
    and the plain backward's times."""
    b, sq, sk, hq, hkv, d, dv, causal, window = case
    name = "float32" if dtype == torch.float32 else "bfloat16"
    shapes = ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv))
    q, k, v = [torch.randn(s, generator=gen, device="cuda").to(dtype).requires_grad_()
               for s in shapes]
    dout = torch.randn((b, sq, hq, dv), generator=gen, device="cuda").to(dtype)
    want_body = fa.body(q, k, v)
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    got = (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    if type(out.grad_fn).__name__ != "FlashAttentionBackward":
        raise AssertionError(f"flash {label}: no FlashAttention node ({out.grad_fn})")
    for n in ("flash_attention", f"flash_attention.{want_body}"):
        require(after, n, after.get(n, 0) == before.get(n, 0) + 1, f"{before.get(n, 0) + 1}")
    pq, pk, pv = grad_leaves(torch, (q, k, v))
    pout = ref.attention_ref(pq, pk, pv, causal, window)
    want = (pout.detach(),) + torch.autograd.grad(pout, (pq, pk, pv), dout.float())
    log(f"  flash {label} {name} q{shapes[0]} k{shapes[1]} v{shapes[2]} "
        f"{'causal' if causal else 'non-causal'}{f' window {window}' if window else ''} "
        f"({want_body}):")
    errs = {part: check_grad_pair(part, g, w, name)
            for part, g, w in zip(("out", "dq", "dk", "dv"), got, want)}
    res = dict(shape=f"q{shapes[0]} k{shapes[1]} v{shapes[2]} {name}", body=want_body,
               errors=errs)
    if window and name == "float32":  # the planted control: a window one row short
        sq_, sk_, sv_ = grad_leaves(torch, (q, k, v))
        short = ref.attention_ref(sq_, sk_, sv_, causal, window - 1)
        planted = (short.detach(),) + torch.autograd.grad(short, (sq_, sk_, sv_),
                                                           dout.float())
        r = max(rel_err(g, p) for g, p in zip(got, planted))
        log(f"    planted control, window {window - 1}: rel={r:.3e} "
            f"{'caught' if r > TRAIN_F32_REL else 'MISSED'}")
        if r <= TRAIN_F32_REL:
            raise AssertionError(f"flash {label}: the check passes a window one row short")
        res["planted_rel"] = r
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    res["fwd_kernel_ms"] = time_ms(lambda: fa.flash_attention_cuda(qd, kd, vd, causal, window),
                                   [()], iters=5)
    res["bwd_plain_ms"] = time_ms(lambda: ref.attention_bwd_ref(qd, kd, vd, dout, causal, window),
                                  [()], iters=5)
    return res


def autograd_ssd_case(torch, ops, ref, ssd, gen, dtype, case):
    """ops.ssd_scan under autograd (SSDScan) on strided views of one conv
    output, as mamba2_block hands them over, against ssd_scan_ref's
    autograd in f32 on the same values; the forward kernel's and the plain
    backward's times."""
    b, s, h, p, n = case
    name = "float32" if dtype == torch.float32 else "bfloat16"
    conv = (torch.randn((b, s, h * p + 2 * n), generator=gen, device="cuda") * 0.5).to(dtype)
    conv.requires_grad_()
    x, Bm, Cm = (conv[..., :h * p].reshape(b, s, h, p), conv[..., h * p:h * p + n],
                 conv[..., h * p + n:])
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    dt.requires_grad_()
    A = (-torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)).requires_grad_()
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    want_body = ssd.body(x, Bm, Cm)
    before = ops.launch_counts()
    y, _ = ops.ssd_scan(x, dt, A, Bm, Cm)
    got = (y.detach(),) + torch.autograd.grad(y, (conv, dt, A), dy)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    if type(y.grad_fn).__name__ != "SSDScanBackward":
        raise AssertionError(f"ssd_scan: no SSDScan node ({y.grad_fn})")
    for nm in ("ssd_scan", f"ssd_scan.{want_body}"):
        require(after, nm, after.get(nm, 0) == before.get(nm, 0) + 1, f"{before.get(nm, 0) + 1}")
    pconv, pdt, pA = grad_leaves(torch, (conv, dt, A))
    py, _ = ref.ssd_scan_ref(pconv[..., :h * p].reshape(b, s, h, p), pdt, pA,
                             pconv[..., h * p:h * p + n], pconv[..., h * p + n:])
    want = (py.detach(),) + torch.autograd.grad(py, (pconv, pdt, pA), dy.float())
    log(f"  ssd_scan {name} x({b},{s},{h},{p}) B/C({b},{s},{n}) strided views ({want_body}):")
    errs = {}
    for part, g, w in zip(("y", "d(x|B|C)", "ddt", "dA"), got, want):
        if name == "bfloat16" and part == "y":
            # the tensor-core body's own bf16 rounding (W and h_enter, which
            # sums the history, go to bf16 A fragments): phase 3's limit
            # for this kernel; the row-scaled reading is reported
            errs["y row-scaled (reported)"] = row_scaled_err(g, w)
            errs[part] = check_close(f"y (row-scaled {errs['y row-scaled (reported)']:.3e}, "
                                     f"reported)", g, w, name, SSD_TOL)
            continue
        if name == "bfloat16" and part == "dA":  # (H,) f32 sums: one row
            g, w = g[None], w[None]
        errs[part] = check_grad_pair(part, g, w, name)
    xd, dtd, Ad, Bd, Cd = (t.detach() for t in (x, dt, A, Bm, Cm))
    zero = torch.zeros((b, h, p, n), device="cuda")
    return dict(shape=f"x({b},{s},{h},{p}) B/C({b},{s},{n}) {name}", body=want_body, errors=errs,
                fwd_kernel_ms=time_ms(lambda: ssd.ssd_scan_cuda(xd, dtd, Ad, Bd, Cd), [()], iters=5),
                bwd_plain_ms=time_ms(lambda: ref.ssd_scan_bwd_ref(
                    xd, dtd, Ad, Bd, Cd, None, dy, zero, (True,) * 5 + (False,)), [()], iters=5))


def loss_and_grads(torch, mb, params, batch, tree_leaves, tree_unflatten):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, _ = mb.loss_fn(tree_unflatten(params, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_vs_cpu(torch, ops, label, cfg, batch_size, seq, seed=0):
    """One f32 step's loss and gradients of ``cfg`` on the card against the
    CPU, same weights (drawn on the host) and batch; the bf16 loss of the
    same weights and batch on the card against the f32 one.  Returns the
    errors and the card runs' launches."""
    from repro_torch.models import bundle
    from repro_torch.training import data
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    mb = bundle(cfg32)
    params = mb.init(torch.Generator().manual_seed(seed), device="cpu")
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch_size,
                           seed=seed,
                           frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
                           frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim,
                           dtype="float32")
    batch = data.get_batch(dcfg, 0, device="cpu")
    l_cpu, g_cpu = loss_and_grads(torch, mb, params, batch, tree_leaves, tree_unflatten)
    ops.reset_launch_counts()
    l_card, g_card = loss_and_grads(
        torch, mb, tree_map(lambda t: t.cuda(), params),
        {k: v.cuda() for k, v in batch.items()}, tree_leaves, tree_unflatten)
    mb16 = bundle(dataclasses.replace(cfg, dtype="bfloat16"))
    p16 = tree_map(lambda t: t.cuda(), bf16_like(torch, params, mb16))
    b16 = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cuda()
           for k, v in batch.items()}
    with torch.no_grad():
        l16, _ = mb16.loss_fn(p16, b16)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    gn_cpu = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_cpu)))
    gn_card = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in g_card)))
    leaf = max(rel_err(a.cpu(), b) for a, b in zip(g_card, g_cpu))
    out = dict(loss_cpu=float(l_cpu), loss_card=float(l_card), loss_card_bf16=float(l16),
               loss_rel=abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu)),
               grad_norm_rel=abs(gn_card - gn_cpu) / gn_cpu, grad_leaf_rel=leaf,
               bf16_loss_rel=abs(float(l16) - float(l_card)) / abs(float(l_card)),
               launches=counts)
    ok = (out["loss_rel"] <= TRAIN_LOSS_REL and out["grad_norm_rel"] <= TRAIN_GNORM_REL
          and leaf <= TRAIN_LEAF_REL and out["bf16_loss_rel"] <= TRAIN_BF16_REL)
    log(f"  {label}: loss cpu {out['loss_cpu']:.6f} card {out['loss_card']:.6f} "
        f"(rel {out['loss_rel']:.2e}, tol {TRAIN_LOSS_REL:g}), grad norm rel "
        f"{out['grad_norm_rel']:.2e} (tol {TRAIN_GNORM_REL:g}), worst leaf {leaf:.2e} "
        f"(tol {TRAIN_LEAF_REL:g}), card bf16 loss {out['loss_card_bf16']:.6f} (rel "
        f"{out['bf16_loss_rel']:.2e}, tol {TRAIN_BF16_REL:g}); launches "
        f"{ {k: v for k, v in sorted(counts.items())} } {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's training step disagrees with the CPU's")
    return out


def bf16_like(torch, params, mb16):
    """``params`` (f32, on the host) in the dtypes of ``mb16``'s leaves: the
    bf16 model's weights, its f32 leaves kept f32."""
    from repro_torch.models.model_zoo import param_specs
    from repro_torch.tree import tree_leaves, tree_unflatten

    specs = list(tree_leaves(param_specs(mb16.cfg)))
    return tree_unflatten(params, [t.to(s.dtype or torch.bfloat16)
                                   for t, s in zip(tree_leaves(params), specs)])


def zamba2_steps(torch, ops, ssd_times):
    """TRAIN_ZAMBA2's steps through make_train_step (as launch/train.py
    builds it), launch counts zeroed just before and read just after: the
    SSD scan layers x steps x 2 (remat) times and flash once per shared
    application a step (the shared block is not rematerialized, as in the
    reference), all through the tensor cores; the SSD forward kernel's and
    its plain backward's times ((a), CUDA events) against the steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import bundle
    from repro_torch.training import data, optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    over, bsz, seq, steps = TRAIN_ZAMBA2
    cfg = dataclasses.replace(get_config(ZAMBA2), **over)
    mb = bundle(cfg)
    params = mb.init(torch.Generator().manual_seed(0), device="cuda")
    ocfg = opt.AdamWConfig()
    state = opt.init(params, ocfg)
    step_fn = make_train_step(mb, ocfg, TrainConfig(remat=True))
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=bsz)
    ops.reset_launch_counts()
    seconds, losses = [], []
    for i in range(steps):
        t = time.perf_counter()
        params, state, m = step_fn(params, state, data.get_batch(dcfg, i, device="cuda"))
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    n_apps = cfg.n_layers // cfg.shared_attn_every
    want = {"ssd_scan": cfg.n_layers * steps * 2, "ssd_scan.tc": cfg.n_layers * steps * 2,
            "flash_attention": n_apps * steps, "flash_attention.tc": n_apps * steps}
    for n, w in want.items():
        require(counts, n, counts.get(n, 0) == w, f"{w}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"zamba2-1.2b training: a loss is not finite: {losses}")
    steady_ms = sum(seconds[1:]) * 1e3
    out = dict(arch=ZAMBA2, cut=over, batch=bsz, seq=seq, losses=losses, step_seconds=seconds,
               launches=counts,
               ssd_fwd_share=ssd_times["fwd_kernel_ms"] * 2 * cfg.n_layers * (steps - 1)
               / steady_ms,
               ssd_bwd_plain_share=ssd_times["bwd_plain_ms"] * cfg.n_layers * (steps - 1)
               / steady_ms)
    log(f"  zamba2-1.2b {over} bf16 batch {bsz} x {seq}: steps {[round(x, 3) for x in seconds]} s, "
        f"SSD forward kernel {out['ssd_fwd_share']:.1%} and plain SSD backward "
        f"{out['ssd_bwd_plain_share']:.1%} of the steady steps; launches "
        f"{ {k: v for k, v in sorted(counts.items())} }")
    return out


def phase_training(torch, F, ops, ref, _build, fa, ssd):
    """Phase 11: (a) the autograd Functions against plain autograd on the card;
    (b) smollm-135m trained at full width through launch/train.py, launch
    counts zeroed just before and read just after; (c) the card against the
    CPU on one step of the TRAIN_VS_CPU cuts; (d) every arch at reduced()
    the same way.  Returns the {"training": ...} summary, the launches of
    (b)'s two training runs (smollm-135m, zamba2-1.2b) together, and flash's
    and the SSD scan's kernel times at (b)'s shapes (with their plain
    backward's) for the kernels line."""
    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    log("phase 11 (a): the autograd Functions against plain autograd")
    autograd = {}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for label, case in TRAIN_FLASH_CASES.items():
        for dname, dtype in dtypes.items():
            autograd[f"flash {label} {dname}"] = autograd_flash_case(
                torch, ops, ref, fa, gen, label, dtype, case)
            torch.cuda.empty_cache()
    for dname, dtype in dtypes.items():
        autograd[f"ssd_scan {dname}"] = autograd_ssd_case(torch, ops, ref, ssd, gen, dtype,
                                                          TRAIN_SSD_CASE)
    # the forward kernels at (b)'s shapes for the kernels line, beside their
    # plain backward's time
    times = {
        "flash_attention": dict(
            time_flash_case(torch, F, ref, fa, gen, *TRAIN_FLASH_CASES[SMOLLM]),
            bwd_plain_ms=autograd[f"flash {SMOLLM} bfloat16"]["bwd_plain_ms"]),
        "ssd_scan": dict(time_ssd_case(torch, ref, _build, ssd, gen, *TRAIN_SSD_CASE, simt=False),
                         bwd_plain_ms=autograd["ssd_scan bfloat16"]["bwd_plain_ms"]),
    }
    t_a = time.perf_counter() - t0

    log("phase 11 (b): smollm-135m at full width through launch/train.py")
    cfg = get_config(SMOLLM)
    args = train_launch.parse_args(TRAIN_ARGS)
    remat = transformer.remat_mode()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    ops.reset_launch_counts()
    run = train_launch.train(args)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    want_flash = cfg.n_layers * 1 * args.steps * 2  # layers x microbatches x steps x remat
    require(counts, "flash_attention", counts.get("flash_attention", 0) == want_flash,
            f"{want_flash} (layers x microbatches x steps x 2 with remat)")
    require(counts, "flash_attention.tc", counts.get("flash_attention.tc", 0) == want_flash,
            f"{want_flash}: every launch through the tensor cores")
    for n in ("decode_attention", "decode_attention_q8", "ssd_scan"):
        require(counts, n, counts.get(n, 0) == 0, "0")
    if not run["improved"]:
        raise AssertionError(f"smollm-135m: the loss did not fall ({run['first']:.4f} -> "
                             f"{run['last']:.4f})")
    steady = sorted(run["step_seconds"][1:])
    s_step = steady[len(steady) // 2]
    # the flash forward kernel's and the plain backward's time at this shape
    # ((a), CUDA events) times their calls in the run, against the run's steps
    timed = autograd[f"flash {SMOLLM} bfloat16"]
    steps_ms = sum(run["step_seconds"][1:]) * 1e3
    n_steady = args.steps - 1
    train_b = dict(arch=SMOLLM, args=TRAIN_ARGS, lr=args.lr, layers=cfg.n_layers,
                   d_model=cfg.d_model,
                   dtype=cfg.dtype, remat="block", losses=run["losses"], first=run["first"],
                   last=run["last"], step_seconds=run["step_seconds"],
                   median_step_s=s_step, tok_per_s=args.batch * args.seq / s_step,
                   peak_mem_bytes=peak, held_before_bytes=base, launches=counts,
                   expected_flash=want_flash,
                   flash_fwd_ms=timed["fwd_kernel_ms"], flash_bwd_plain_ms=timed["bwd_plain_ms"],
                   flash_fwd_share=timed["fwd_kernel_ms"] * 2 * cfg.n_layers * n_steady / steps_ms,
                   flash_bwd_plain_share=timed["bwd_plain_ms"] * cfg.n_layers * n_steady
                   / steps_ms)
    log(f"  smollm-135m: loss {run['first']:.4f} -> {run['last']:.4f}, median step "
        f"{s_step:.4f} s ({train_b['tok_per_s']:.1f} tok/s), first step "
        f"{run['step_seconds'][0]:.3f} s, peak {peak / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before; flash forward kernel "
        f"{train_b['flash_fwd_share']:.1%} and plain attention backward "
        f"{train_b['flash_bwd_plain_share']:.1%} of the steady steps; launches "
        f"{ {k: v for k, v in sorted(counts.items())} }")
    train_b["zamba2"] = zamba2_steps(torch, ops, autograd["ssd_scan bfloat16"])
    transformer.set_remat(remat)
    t_b = time.perf_counter() - t0 - t_a
    torch.cuda.empty_cache()

    log("phase 11 (c): one f32 step on the card against the CPU, full width, depth cut")
    vs_cpu = {}
    for arch, (over, bsz, seq) in TRAIN_VS_CPU.items():
        c = dataclasses.replace(get_config(arch), **over)
        vs_cpu[arch] = train_vs_cpu(torch, ops, f"{arch} {over} batch {bsz} x {seq}", c, bsz, seq)
        want = {"ssd_scan": arch == ZAMBA2, "flash_attention": True}
        for n, used in want.items():
            require(vs_cpu[arch]["launches"], n,
                    (vs_cpu[arch]["launches"].get(n, 0) > 0) == used,
                    "> 0" if used else "0")
        torch.cuda.empty_cache()
    log("phase 11 (d): every arch at reduced(), one f32 step on the card against the CPU")
    reduced_runs = {}
    for arch in sorted(ARCHS):
        c = reduced(get_config(arch), capacity_factor=4.0)
        reduced_runs[arch] = train_vs_cpu(torch, ops, f"{arch} reduced", c, 2, 64)
    total = time.perf_counter() - t0
    log(f"phase 11: {total:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c)+(d) "
        f"{total - t_a - t_b:.1f}; target {TRAIN_PHASE_TARGET_S:g})")
    z_counts = train_b["zamba2"]["launches"]
    both = {n: counts.get(n, 0) + z_counts.get(n, 0) for n in set(counts) | set(z_counts)}
    for name, t in times.items():
        t["launches"] = both.get(name, 0)
    return dict(autograd=autograd, smollm=train_b, vs_cpu=vs_cpu, reduced=reduced_runs,
                seconds=total), both, times


#: phase 12 (a): phase 11 (b)'s run (TRAIN_ARGS) through torchrun on one
#: NCCL rank, cut at DIST_RESUME_AT (its checkpoint at step 49) and
#: relaunched to the end; the resumed steps are held to phase 11 (b)'s
#: uninterrupted losses within DIST_RESUME_REL
DIST_RESUME_AT = 50
DIST_RESUME_REL = 1e-3
DIST_PHASE_TARGET_S = 90.0


def dist_resume_run(steps: int, ckpt: str, report: str) -> dict:
    """launch/train.py through torchrun on one rank (NCCL) with TRAIN_ARGS,
    to ``steps``, checkpoints in ``ckpt``; returns its --report JSON."""
    args = list(TRAIN_ARGS)
    args[args.index("--steps") + 1] = str(steps)
    if os.path.exists(report):
        os.remove(report)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "repro_torch.launch.train", *args, "--ckpt-dir", ckpt, "--ckpt-every",
           str(DIST_RESUME_AT), "--report", report]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    secs = time.perf_counter() - t0
    # the launcher exits 1 when a run's loss did not fall; the report is
    # written only by a run that reached its end
    if not os.path.exists(report):
        raise AssertionError(f"torchrun launch/train.py to step {steps} failed (exit "
                             f"{out.returncode}):\n{out.stderr[-3000:]}")
    with open(report) as f:
        rep = json.load(f)
    rep["wall_s"] = secs
    for line in out.stdout.splitlines():
        if line.startswith(("arch=", "resumed")):
            log(f"    {line}")
    return rep


def phase_distribution(torch, training: dict) -> dict:
    """Phase 12: phase 11 (b)'s training through torchrun on one NCCL rank,
    cut at step DIST_RESUME_AT and resumed from its checkpoint: the resumed
    steps' losses against phase 11 (b)'s uninterrupted run, and the launches
    of both launches together against phase 11 (b)'s.  Several ranks sharing
    the card over gloo are not run here: DTensor's all-gather crashes on
    gloo with CUDA tensors (tools/gloo_cuda_collectives.py).  Returns the
    {"distribution": ...} summary."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase12")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log("phase 12: launch/train.py through torchrun (one NCCL rank), cut and resumed")
    ckpt = os.path.join(work, "ckpt")
    first = dist_resume_run(DIST_RESUME_AT, ckpt, os.path.join(work, "run1.json"))
    second = dist_resume_run(int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1]), ckpt,
                             os.path.join(work, "run2.json"))
    shutil.rmtree(ckpt, ignore_errors=True)
    whole = training["smollm"]["losses"]
    if first["world"] != 1 or second["world"] != 1 or second["start"] != DIST_RESUME_AT:
        raise AssertionError(f"phase 12: worlds {first['world']}/{second['world']}, "
                             f"resumed at {second['start']}")
    resumed = second["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, whole[DIST_RESUME_AT:])]
    if len(resumed) != len(whole) - DIST_RESUME_AT or max(rel) > DIST_RESUME_REL:
        raise AssertionError(f"phase 12: the resumed losses drift from phase 11 (b)'s "
                             f"uninterrupted run by up to {max(rel):.3e}")
    # the first launch's steps are phase 11 (b)'s too (one rank keeps every
    # tensor plain)
    rel_first = [abs(a - b) / abs(b) for a, b in zip(first["losses"], whole)]
    if len(first["losses"]) != DIST_RESUME_AT or max(rel_first) > DIST_RESUME_REL:
        raise AssertionError(f"phase 12: the first launch's losses drift from phase 11 "
                             f"(b)'s by up to {max(rel_first):.3e}")
    cfg = get_config(SMOLLM)
    want_flash = cfg.n_layers * len(whole) * 2
    both = {n: first["launches"].get(n, 0) + second["launches"].get(n, 0)
            for n in set(first["launches"]) | set(second["launches"])}
    for n, want in (("flash_attention", want_flash), ("flash_attention.tc", want_flash),
                    ("decode_attention", 0), ("decode_attention_q8", 0), ("ssd_scan", 0)):
        require(both, n, both.get(n, 0) == want, str(want))
    medians = [sorted(r["step_seconds"][1:])[len(r["step_seconds"][1:]) // 2]
               for r in (first, second)]
    shutil.rmtree(work, ignore_errors=True)
    total = time.perf_counter() - t0
    log(f"  steps 0-{DIST_RESUME_AT - 1}: max loss drift {max(rel_first):.3e}; resumed steps "
        f"{DIST_RESUME_AT}-{len(whole) - 1}: {max(rel):.3e} (limit {DIST_RESUME_REL:g}); "
        f"launches {both}; walls {first['wall_s']:.1f} s + {second['wall_s']:.1f} s, median "
        f"steps {medians[0]:.4f} / {medians[1]:.4f} s")
    log(f"phase 12: {total:.1f} s (target {DIST_PHASE_TARGET_S:g})")
    return dict(args=TRAIN_ARGS, resume_at=DIST_RESUME_AT, max_loss_rel_first=max(rel_first),
                max_loss_rel_resumed=max(rel), losses=[first["losses"], resumed],
                launches=both, expected_flash=want_flash,
                wall_s=[first["wall_s"], second["wall_s"]], median_step_s=medians,
                seconds=total)


# ---------------------------------------------------------------------------
# phase 13: the static cost analysis held to the card
# ---------------------------------------------------------------------------
#: (a) the dry-run of smollm-135m's four shapes on a fake pod16x16 process
#: group (256 ranks, meta tensors: no card), in a subprocess of its own so
#: that the fake group never meets phase 12's NCCL state; started before
#: phase 11 and read after phase 12
COST_DRYRUN_ARGS = ["--arch", SMOLLM, "--mesh", "single"]
COST_DRYRUN_TIMEOUT_S = 600
#: (a) each cell's counted FLOPs x 256 against smollm_analytic_flops
COST_FLOPS_REL = 0.02
#: (b) the counted memory of one step (arguments + the peak of the rest)
#: over the rise in max_memory_allocated across one real step on the card
COST_MEM_RANGE = (0.5, 2.0)
#: (c) every arch's full-width inference cells on the fake pod16x16 group;
#: long_500k is skipped where the reference skips it (full attention).
#: Three worker processes: xlstm-125m's prefill_32k alone (its sLSTM loop
#: runs 32768 steps per layer), the other prefills with long_500k, and the
#: decodes with (d)
COST_FULL_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
#: (d) every arch's reduced() train, prefill and decode cells on a fake
#: (2, 2) group, as tests/test_torch_dryrun.py's test_reduced_cells builds
#: them: (name, seq_len, global_batch, kind, microbatch)
COST_REDUCED_SHAPES = (("train_4k", 8, 16, "train", 16), ("prefill_32k", 8, 4, "prefill", 0),
                       ("decode_32k", 8, 4, "decode", 0))
COST_WORKERS_TIMEOUT_S = 600
#: (e) the sharded train step of these archs on 4 gloo CPU ranks on a
#: (2, 2) mesh at reduced(), against the unsharded step, with the limits of
#: tests/test_torch_distributed*.py: {arch: (MoE mode, reduced() overrides)}.
#: Mixtral's expert-parallel layer at capacity 8, as tests/test_torch_moe_ep.py
#: runs it: each rank's buffers then drop no token, nor do the unsharded
#: step's dispatch groups, which drop others at a tighter capacity
COST_GLOO_ARCHS = {ZAMBA2: ("dispatch", {}), MIXTRAL: ("alltoall", {"capacity_factor": 8.0}),
                   DEEPSEEK: ("dispatch", {}), XLSTM: ("dispatch", {})}
COST_GLOO_LOSS_REL, COST_GLOO_LEAF_REL = 1e-5, 1e-4
COST_GLOO_SEQ, COST_GLOO_BATCH = 16, 8


def start_dryrun():
    """Phase 13 (a)'s subprocess: ``python -m repro_torch.launch.dryrun``
    with its artifacts and log under build/phase13.  Returns [process,
    artifact directory, start time]."""
    out = os.path.join(ROOT, "build", "phase13")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    with open(os.path.join(out, "dryrun.log"), "w") as f:
        # at the lowest priority: phases 11 and 12 time their steps beside it
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 *COST_DRYRUN_ARGS, "--out", out], cwd=ROOT, env=env,
                                stdout=f, stderr=subprocess.STDOUT,
                                preexec_fn=lambda: os.nice(19))
    return [proc, out, time.perf_counter()]


def smollm_analytic_flops(shape) -> float:
    """The matmul FLOPs of one step of smollm-135m over all 256 ranks of the
    (16, 16) mesh, term by term: the Q, K, V, O and SwiGLU projections of 30
    layers and the tied LM head, sharded with no rank repeating another's
    work; attention at the kernel's pairs (the causal prefill's, or the
    whole cache at decode) on every rank of ``model``, since 9 query heads
    and 3 KV heads do not divide 16 ranks.  A train step adds remat's
    second forward of each layer, the projections' two backward products,
    the head's two, and the plain attention backward's five (query chunk x
    every key) products per layer.  What the count finds beyond this is
    work DTensor repeats on every rank of ``model`` (1.45% of train_4k:
    weight gradients of the attention output, whose input is replicated
    there); tests/test_torch_dryrun.py holds prefill and decode on the
    CPU, where train_4k takes minutes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost

    cfg = get_config(SMOLLM)
    d, hd, f, v = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.vocab_size
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (1 if shape.kind == "decode" else s)
    proj = 2 * tokens * d * (hq * hd + 2 * hkv * hd + hq * hd + 3 * f)
    head = 2 * tokens * d * v
    if shape.kind == "decode":
        return n * proj + head + 16 * n * 2 * hq * b * s * (hd + hd)
    fwd_attn = 2 * b * hq * cost.attention_pairs(s, s, True, None) * (hd + hd)
    if shape.kind == "prefill":
        return n * proj + head + 16 * n * fwd_attn
    bwd_attn = 5 * 2 * b * hq * s * s * hd
    return 4 * n * proj + 3 * head + 16 * n * (2 * fwd_attn + bwd_attn)


def phase_cost_analysis(torch, ops, device_label: str, training: dict, dry, workers) -> dict:
    """Phase 13: (a) the dry-run's smollm-135m cells on the fake pod16x16
    group (``cost_dryrun_cells``), (b) one rank at phase 11 (b)'s shape
    (``cost_one_rank``), (c)-(e) every arch's sharded cells and the gloo
    steps (``cost_workers_results``).  Returns the {"cost_analysis": ...}
    summary, with this torch's version and each (arch, cell)'s status."""
    t0 = time.perf_counter()
    log("phase 13 (a): the dry-run of smollm-135m on a fake pod16x16 process group")
    cells = cost_dryrun_cells(dry, device_label)
    t_a = time.perf_counter() - t0
    log("phase 13 (b): one rank at phase 11 (b)'s shape, counted and on the card")
    one_rank = cost_one_rank(torch, ops, device_label, training["smollm"])
    t_b = time.perf_counter()
    log(f"phase 13 (c)-(e) on torch {torch.__version__}: every arch's cells on fake groups, "
        "the sharded train step on 4 gloo ranks")
    archs = cost_workers_results(workers, device_label)
    t_ce = time.perf_counter() - t_b
    total = time.perf_counter() - t0
    log(f"phase 13: {total:.1f} s ((a) waited {t_a:.1f} s; the dry-run took "
        f"{dry[3]:.1f} s beside phases 11-12; (c)-(e) waited {t_ce:.1f} s, "
        f"{archs['waited_s']:.1f} s since their start)")
    status = {f"{SMOLLM}/{k}": v["status"] for k, v in cells.items()}
    status.update(archs["status"])
    return dict(device=device_label, torch=torch.__version__, status=status, dryrun=cells,
                one_rank=one_rank, dryrun_s=dry[3], archs=archs, seconds=total)


def cost_dryrun_cells(dry, device_label: str) -> dict:
    """Phase 13 (a): each of smollm-135m's cells "ok" (long_500k "skipped"),
    its FLOPs x 256 within COST_FLOPS_REL of the analytic count.  Waits for
    the subprocess and appends its wall seconds to ``dry``."""
    from repro_torch.configs import SHAPES

    proc, out, started = dry[:3]
    try:
        rc = proc.wait(max(1.0, COST_DRYRUN_TIMEOUT_S - (time.perf_counter() - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"phase 13: the dry-run outlived {COST_DRYRUN_TIMEOUT_S} s")
    dry.append(time.perf_counter() - started)
    with open(os.path.join(out, "dryrun.log")) as f:
        dry_log = f.read()
    if rc != 0:
        raise AssertionError(f"phase 13: the dry-run exited {rc}:\n{dry_log[-3000:]}")
    cells = {}
    for name, shape in SHAPES.items():
        with open(os.path.join(out, "pod16x16", f"{SMOLLM}__{name}.json")) as f:
            cell = json.load(f)
        if name == "long_500k":
            if cell["status"] != "skipped":
                raise AssertionError(f"phase 13: {name} is {cell['status']}, not skipped")
            cells[name] = dict(status=cell["status"], reason=cell["reason"])
            continue
        if cell["status"] != "ok":
            raise AssertionError(f"phase 13: {name}: {cell.get('error')}")
        got = cell["per_device"]["flops"] * cell["n_devices"]
        want = smollm_analytic_flops(shape)
        r = cell["roofline"]
        cells[name] = dict(status="ok", n_devices=cell["n_devices"], count_s=cell["count_s"],
                           per_device=cell["per_device"], kernels=cell["kernels"],
                           roofline=r, useful_ratio=cell["useful_ratio"],
                           model_flops=cell["model_flops"], flops_total=got,
                           analytic_flops=want, vs_analytic=got / want)
        log(f"  {name}: compute {r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} "
            f"ms, collective {r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}, "
            f"useful ratio {cell['useful_ratio']:.4f}, FLOPs x 256 / analytic {got / want:.4f}, "
            f"counted in {cell['count_s']:.1f} s (H100 datasheet peaks; card {device_label})")
        if abs(got / want - 1) > COST_FLOPS_REL:
            raise AssertionError(f"phase 13: {name}'s FLOPs x 256 are {got / want:.4f} of the "
                                 f"analytic count (limit {COST_FLOPS_REL:g})")
    return cells


def cost_one_rank(torch, ops, device_label: str, run: dict) -> dict:
    """Phase 13 (b): smollm-135m at phase 11 (b)'s shape (``run``: its
    summary) counted on ``meta`` on one rank: the flash calls booked a step
    against the launches a step phase 11 measured and one real step's, the
    counted memory against the real step's rise in max_memory_allocated,
    and the roofline bound against phase 11 (b)'s median step."""
    from repro_torch.configs import get_config
    from repro_torch.distribution.cost_analysis import CostCounter
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_launch
    from repro_torch.models import bundle, transformer
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    args = train_launch.parse_args(TRAIN_ARGS)
    cfg = get_config(SMOLLM)
    mb = bundle(cfg)
    ocfg = opt.AdamWConfig(lr=args.lr)
    remat = transformer.remat_mode()
    step = make_train_step(mb, ocfg, TrainConfig(microbatch=args.microbatch, remat=True))
    params = mb.param_shapes()
    state = opt.init(params, ocfg)
    batch = {"tokens": torch.empty((args.batch, args.seq), dtype=torch.int32, device="meta")}
    counter = CostCounter()
    counter.track_arguments(params, state, batch)
    with counter:
        step(params, state, batch)
    del params, state, batch
    booked = counter.kernels.get("flash_attention", {}).get("calls", 0)
    per_step = run["launches"].get("flash_attention", 0) / len(run["losses"])
    per_step_tc = run["launches"].get("flash_attention.tc", 0) / len(run["losses"])
    if booked != per_step or per_step_tc != per_step or set(counter.kernels) != {"flash_attention"}:
        raise AssertionError(f"phase 13: the count books {counter.kernels} a step, phase 11 "
                             f"launched flash {per_step} ({per_step_tc} .tc) a step")
    # one real step: the rise in allocated memory from before its arguments
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda = torch.device("cuda")
    params = train_launch.init_params(mb, args.seed, cuda)
    state = opt.init(params, ocfg)
    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed, dtype=cfg.dtype)
    batch = data_mod.get_batch(dcfg, 0, device=cuda)
    ops.reset_launch_counts()
    result = step(params, state, batch)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    launched = ops.launch_counts()
    del params, state, batch, result
    transformer.set_remat(remat)
    torch.cuda.empty_cache()
    if launched.get("flash_attention", 0) != booked:
        raise AssertionError(f"phase 13: the real step launched {launched}, the count booked "
                             f"{booked} flash calls")
    est = counter.argument_bytes + counter.temp_bytes
    lo, hi = COST_MEM_RANGE
    if not lo <= est / rise <= hi:
        raise AssertionError(f"phase 13: counted memory {est} B is {est / rise:.3f} of the real "
                             f"step's {rise} B (limits {lo}-{hi})")
    tot = counter.totals
    compute_s, memory_s = tot.flops / dryrun.PEAK_FLOPS, tot.bytes / dryrun.HBM_BW
    bound_s = max(compute_s, memory_s)
    median = run["median_step_s"]
    log(f"  counted: {tot.flops:.4e} FLOPs, {tot.bytes:.4e} bytes, flash booked {booked} a step "
        f"(phase 11 launched {per_step:g}, all .tc; the real step "
        f"{launched.get('flash_attention')}); memory: arguments {counter.argument_bytes} + peak {counter.temp_bytes} = {est} B vs "
        f"the real step's rise {rise} B ({est / rise:.3f}); roofline bound "
        f"{bound_s * 1e3:.2f} ms (compute {compute_s * 1e3:.2f}, memory {memory_s * 1e3:.2f}) = "
        f"{bound_s / median:.3f} of phase 11 (b)'s median step {median:.4f} s ({device_label})")
    return dict(args=TRAIN_ARGS, flops=tot.flops, bytes=tot.bytes, kernels=counter.kernels,
                flash_per_step_phase11=per_step, flash_real_step=launched.get("flash_attention"),
                argument_bytes=counter.argument_bytes, temp_bytes=counter.temp_bytes,
                counted_bytes=est, real_step_rise_bytes=rise, memory_ratio=est / rise,
                compute_s=compute_s, memory_s=memory_s, bound_s=bound_s, median_step_s=median,
                bound_over_step=bound_s / median)


def cost_expected_calls(cfg, kind: str) -> dict:
    """The kernel calls one step of ``kind`` books (tests/test_torch_dryrun.py's
    ``expected_calls``): each kernel layer once, the blocks of the layer
    groups twice under the train step's remat (the shared attention block,
    the encoder-decoder trunk and the MTP block are not rematerialized)."""
    from repro_torch.models import transformer

    m = transformer.Model(cfg)
    attn = sum(n for k, n in m._groups() if k in ("attn", "moe"))
    mamba = sum(n for k, n in m._groups() if k == "mamba2")
    shared, mla = m.n_shared_apps, cfg.attention == "mla"
    if cfg.enc_dec:
        enc, dec = cfg.n_encoder_layers, cfg.n_layers
        return {"train": {"flash_attention": enc + 2 * dec},
                "prefill": {"flash_attention": enc + 2 * dec},
                "decode": {"decode_attention": dec, "flash_attention": dec}}[kind]
    calls = {"train": {"flash_attention": 2 * attn + shared + (1 if cfg.mtp_depth else 0),
                       "ssd_scan": 2 * mamba},
             "prefill": {"flash_attention": attn + shared, "ssd_scan": mamba},
             "decode": {"decode_attention": 0 if mla else attn + shared}}[kind]
    return {k: v for k, v in calls.items() if v}


def cost_cells_worker(out_path: str, cells) -> None:
    """Phase 13 (c) and (d), in a process of its own at the lowest
    priority: each (arch, shape name, reduced shape or None) of ``cells``
    through ``launch.dryrun.run_cell`` on a fake process group (full width
    on pod16x16, or ``reduced()`` on (2, 2) with the given
    COST_REDUCED_SHAPES entry); the summaries go to ``out_path`` as JSON
    after every cell."""
    os.nice(19)
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    res = {}
    for arch, name, red in cells:
        t0 = time.perf_counter()
        if red is None:
            key, cell = f"{arch}/{name}", dryrun.run_cell(arch, name, False, out_dir=None)
        else:
            shape = ShapeConfig(*red[:4], microbatch=red[4])
            key = f"{arch}/reduced/{shape.kind}"
            cell = dryrun.run_cell(arch, name, False, cfg=reduced(get_config(arch)), shape=shape,
                                   mesh_shape=((2, 2), ("data", "model")), out_dir=None)
        pd = cell.get("per_device", {})
        res[key] = dict(status=cell["status"], error=cell.get("error"),
                        traceback=(cell.get("traceback") or "")[-1500:] or None,
                        kernels={k: v["calls"] for k, v in cell.get("kernels", {}).items()},
                        flops=pd.get("flops"), hbm_bytes=pd.get("hbm_bytes"),
                        collective_bytes=pd.get("collective_bytes"),
                        roofline=cell.get("roofline"), useful_ratio=cell.get("useful_ratio"),
                        count_s=cell.get("count_s"), wall_s=time.perf_counter() - t0)
        with open(out_path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(out_path + ".tmp", out_path)


def cost_gloo_step(arch: str, mesh) -> dict:
    """Phase 13 (e): reduced ``arch``'s loss and every gradient leaf on batch
    0 from seeded weights, with the parameters placed on ``mesh`` as the
    train step places them (fsdp) and the batch over the data axis, or
    plain for None; gathered whole as f32 numpy ({"loss", "leaf<i>"})."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, reduced
    from repro_torch.distribution import sharding as shd
    from repro_torch.models import bundle
    from repro_torch.models import moe as moe_mod
    from repro_torch.training import data as tdata
    from repro_torch.tree import tree_leaves, tree_unflatten

    def whole(x):
        return (x.full_tensor() if shd.is_dtensor(x) else x).detach().float().numpy()

    moe_impl, overrides = COST_GLOO_ARCHS[arch]
    moe_mod.set_moe_impl(moe_impl)
    cfg = reduced(get_config(arch), **overrides)
    mb = bundle(cfg)
    params = mb.init(torch.Generator().manual_seed(0), device="cpu")
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=COST_GLOO_SEQ,
                            global_batch=COST_GLOO_BATCH,
                            frontend=cfg.frontend or ("audio" if cfg.enc_dec else None),
                            frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim,
                            dtype=cfg.dtype)
    batch = tdata.get_batch(dcfg, 0, device="cpu")
    ctx = rep = contextlib.nullcontext()
    if mesh is not None:
        params = shd.distribute(params, shd.param_specs(params, mesh, True), mesh)
        batch = tdata.shard_batch(batch, mesh)
        ctx, rep = shd.use_mesh(mesh, fsdp=True), implicit_replication()
    with ctx:
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        with rep:
            loss, _ = mb.loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        out = {"loss": whole(loss)}
        out.update((f"leaf{i}", whole(g)) for i, g in enumerate(grads))
    moe_mod.set_moe_impl("dispatch")
    return out


def cost_gloo_rank(rank: int, world: int, init: str, out_dir: str, plain: bool) -> None:
    """Phase 13 (e)'s process: one gloo rank of the (2, 2) mesh (rank 0
    saves the gathered results), or with ``plain`` the unsharded runs."""
    os.nice(19)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if plain:
        for arch in COST_GLOO_ARCHS:
            np.savez(os.path.join(out_dir, f"{arch}-plain.npz"), **cost_gloo_step(arch, None))
        return
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for arch in COST_GLOO_ARCHS:
            out = cost_gloo_step(arch, mesh)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{arch}-sharded.npz"), **out)
    finally:
        dist.destroy_process_group()


def start_cost_workers():
    """Phase 13 (c)-(e)'s processes, started beside (a) before phase 11:
    three dry-run workers (``cost_cells_worker``) and the four gloo ranks of
    (e) with the unsharded run beside them (``cost_gloo_rank``).  Returns
    {"procs": [...], "dir": ..., "cells": {path: cells}, "started": t}."""
    import multiprocessing as mp

    from repro_torch.configs import ARCHS

    out = os.path.join(ROOT, "build", "phase13", "workers")
    os.makedirs(out)
    archs = sorted(ARCHS)
    full = [(a, n, None) for n in COST_FULL_SHAPES for a in archs]
    slow = [(XLSTM, "prefill_32k", None)]
    decodes = [c for c in full if c[1] == "decode_32k"]
    groups = {
        "c_xlstm_prefill.json": slow,
        "c_prefill_long.json": [c for c in full if c not in slow + decodes],
        "c_decode_d.json": decodes + [(a, r[0], r) for a in archs for r in COST_REDUCED_SHAPES],
    }
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=cost_cells_worker, args=(os.path.join(out, name), cells))
             for name, cells in groups.items()]
    init = f"file://{os.path.join(out, 'rendezvous')}"
    procs += [ctx.Process(target=cost_gloo_rank, args=(r, 4, init, out, False)) for r in range(4)]
    procs.append(ctx.Process(target=cost_gloo_rank, args=(0, 4, init, out, True)))
    for p in procs:
        p.start()
    return dict(procs=procs, dir=out, cells=groups, started=time.perf_counter())


def stop_processes(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


def cost_workers_results(workers, device_label: str) -> dict:
    """Phase 13 (c)-(e): waits for the processes (COST_WORKERS_TIMEOUT_S from
    their start), then gates (c) each full-width cell "ok", or "skipped"
    exactly where the arch does not support the shape (the reference's
    skip), (d) each reduced cell "ok", and both with the booked kernel
    calls of ``cost_expected_calls``; (e) each arch's sharded loss within
    COST_GLOO_LOSS_REL of the unsharded loss and every gradient leaf within
    COST_GLOO_LEAF_REL of its leaf's max."""
    import torch

    from repro_torch.configs import SHAPES, get_config, reduced
    from repro_torch.models import bundle

    deadline = workers["started"] + COST_WORKERS_TIMEOUT_S
    for p in workers["procs"]:
        p.join(max(0.0, deadline - time.perf_counter()))
    hung = [p.pid for p in workers["procs"] if p.is_alive()]
    waited = time.perf_counter() - workers["started"]
    stop_processes(workers["procs"])
    failed = [(p.pid, p.exitcode) for p in workers["procs"] if p.exitcode not in (0, None)]
    cells, errors = {}, []
    for name in workers["cells"]:
        path = os.path.join(workers["dir"], name)
        if os.path.exists(path):
            with open(path) as f:
                cells.update(json.load(f))
    for group in workers["cells"].values():
        for arch, name, red in group:
            key = f"{arch}/{name}" if red is None else f"{arch}/reduced/{red[3]}"
            cell = cells.get(key)
            if cell is None:
                errors.append(f"{key}: not counted")
                continue
            cfg = get_config(arch) if red is None else reduced(get_config(arch))
            kind = SHAPES[name].kind if red is None else red[3]
            skip = red is None and not bundle(cfg).supports_shape(SHAPES[name])
            want = "skipped" if skip else "ok"
            if cell["status"] != want:
                errors.append(f"{key}: {cell['status']} (want {want}): {cell.get('error')}\n"
                              f"{cell.get('traceback')}")
            elif want == "ok" and cell["kernels"] != cost_expected_calls(cfg, kind):
                errors.append(f"{key}: booked {cell['kernels']}, want "
                              f"{cost_expected_calls(cfg, kind)}")
            if cell["status"] == "ok":
                r = cell["roofline"]
                log(f"  {key}: compute {r['compute_s'] * 1e3:.4g} ms, memory "
                    f"{r['memory_s'] * 1e3:.4g} ms, collective {r['collective_s'] * 1e3:.4g} ms, "
                    f"{r['dominant']}, useful {cell['useful_ratio']:.4f}, booked "
                    f"{cell['kernels']}, counted in {cell['count_s']:.1f} s")
            else:
                log(f"  {key}: {cell['status']}")
    gloo = {}
    for arch in COST_GLOO_ARCHS:
        paths = [os.path.join(workers["dir"], f"{arch}-{k}.npz") for k in ("sharded", "plain")]
        if not all(os.path.exists(q) for q in paths):
            errors.append(f"(e) {arch}: no result")
            continue
        got, want = (np.load(q) for q in paths)
        loss_rel = float(abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        leaves = [k for k in want.files if k != "loss"]
        leaf_rel = max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
                       for k in leaves)
        gloo[arch] = dict(moe_impl=COST_GLOO_ARCHS[arch][0], overrides=COST_GLOO_ARCHS[arch][1],
                          loss=float(got["loss"]),
                          loss_unsharded=float(want["loss"]), loss_rel=loss_rel,
                          max_leaf_rel=leaf_rel, leaves=len(leaves))
        log(f"  (e) {arch} ({COST_GLOO_ARCHS[arch][0]}) on 4 gloo ranks (2, 2): loss "
            f"{got['loss']:.7f}"
            f" vs {want['loss']:.7f} unsharded ({loss_rel:.2e}), worst of {len(leaves)} gradient "
            f"leaves {leaf_rel:.2e} of its max")
        if loss_rel > COST_GLOO_LOSS_REL or leaf_rel > COST_GLOO_LEAF_REL:
            errors.append(f"(e) {arch}: loss {loss_rel:.3g} (limit {COST_GLOO_LOSS_REL:g}), "
                          f"leaf {leaf_rel:.3g} (limit {COST_GLOO_LEAF_REL:g})")
    if hung or failed or errors:
        raise AssertionError(f"phase 13 (c)-(e): processes still running {hung}, failed "
                             f"{failed}; " + "\n".join(errors))
    return dict(torch=torch.__version__, waited_s=waited,
                status={k: v["status"] for k, v in sorted(cells.items())}, cells=cells,
                gloo=gloo, card=device_label)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as dec, decode_attention_q8 as q8
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ssd
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import bundle, layers
    from repro_torch.serving import Engine, EngineConfig, Request
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device_label = phase_device()
    phase_build(_build)
    phase_kernels(torch, ops, ref, fa, dec, q8, ssd)
    runs = phase_engines(torch, ops, serve, layers)
    for arch in (SMOLLM, ZAMBA2):
        phase_vs_cpu(torch, runs[arch][0], Engine, EngineConfig, Request, bundle, tree_map)
    xmb = bundle(get_config(XLSTM))
    xres = {"bundle": xmb,
            "params": xmb.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")}
    phase_vs_cpu(torch, xres, Engine, EngineConfig, Request, bundle, tree_map, XLSTM_REL_TOL)
    del xres
    entries = phase_timing(torch, F, ref, _build, fa, dec, q8, ssd, runs)
    torch.cuda.empty_cache()
    calibration, cal_counts, perf, cal_times = phase_calibration(torch, F, ops, ref)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cluster, cluster_counts = phase_cluster(torch, ops, serve, perf)
    fleet = phase_fleet(torch, perf)
    torch.cuda.empty_cache()
    families = phase_families(torch, ops, Engine, EngineConfig, Request, bundle, tree_map)
    fam_flash, fam_decode = family_kernel_times(torch, F, ref, fa, dec, families)
    entries[0]["families"], entries[1]["families"] = fam_flash, fam_decode
    torch.cuda.empty_cache()
    dry = start_dryrun()
    workers = None
    try:
        workers = start_cost_workers()
        training, train_counts, train_times = phase_training(torch, F, ops, ref, _build, fa, ssd)
        torch.cuda.empty_cache()
        distribution = phase_distribution(torch, training)
        torch.cuda.empty_cache()
        cost_analysis = phase_cost_analysis(torch, ops, device_label, training, dry, workers)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        if workers is not None:
            stop_processes(workers["procs"])
    for e in entries:
        e["launches_by_path"]["training"] = train_counts.get(e["name"], 0)
        if e["name"] in train_times:
            e["training"] = train_times[e["name"]]
    for e in entries:
        e["launches_by_path"]["calibration"] = cal_counts.get(e["name"], 0)
        if e["name"] in cal_times:
            e["calibration"] = cal_times[e["name"]]
        e["launches_by_path"]["cluster"] = cluster_counts.get(e["name"], 0)
        for arch, run in families["runs"].items():
            e["launches_by_path"][arch] = run["launches"].get(e["name"], 0)
    for e in entries:
        for path, t in [(e["launches_path"], e)] + [(p, e[k]) for p, k in (
                (ZAMBA2, "zamba2"), ("calibration", "calibration"), ("training", "training"))
                if k in e]:
            lib = "none" if t["library_ms"] is None else (
                f"{t['library_ms']:.4f} ms, device {t['library_device_ms']:.4f} ms")
            log(f"  {e['name']} {t['shape']}: {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms "
                f"({t['device_ms_source']}; bound {t['bound_ms']:.5f} ms by {t['bound_by']}, "
                f"plain {t['plain_ms']:.4f} ms, library {lib}"
                + (f", CUDA-core body device {t['simt_device_ms']:.4f} ms" if "simt_device_ms" in t
                   else "") + f"), {t['launches']} launches in the {path} run")
        for arch, fam in e.get("families", {}).items():
            for t in fam["shapes"]:
                log(f"  {e['name']} {arch} {t['shape']}: {t['ms']:.4f} ms, device "
                    f"{t['device_ms']:.4f} ms (bound {t['bound_ms']:.5f} ms by {t['bound_by']}, "
                    f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, device "
                    f"{t['library_device_ms']:.4f} ms), {fam['launches']} launches in the "
                    f"{arch} run")
    for arch, (res, _, _) in runs.items():
        log(f"  engine {arch}: {res['tok_per_s']:.1f} tok/s")
    for arch, run in families["runs"].items():
        log(f"  engine {arch} ({run['cut']}): {run['tok_per_s']:.1f} tok/s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"calibration": calibration}))
    log(json.dumps({"cluster": cluster}))
    log(json.dumps({"fleet": fleet}))
    log(json.dumps({"families": families}))
    log(json.dumps({"training": training}))
    log(json.dumps({"distribution": distribution}))
    log(json.dumps({"cost_analysis": cost_analysis}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
