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
     and on strided views of one tensor as mamba2_block hands them over;
  4. three engine runs at full width through repro_torch.launch.serve's
     engine path, each of 16 seeded requests with bf16 seeded random weights:
     smollm-135m, zamba2-1.2b (Mamba-2 + shared attention), and smollm-135m
     with an int8 KV cache (layers.set_kv_quant).  The kernels' launch counts
     are zeroed just before each run and read just after; each run must
     have launched the kernels of its path (zamba2: the SSD scan exactly
     once per Mamba-2 layer per request; int8: only the int8 decode kernel;
     every flash and every SSD launch through the tensor-core body), and
     each count must equal EXPECTED_LAUNCHES (the request mix fixes them);
  5. smollm-135m and zamba2-1.2b on the card, in bf16 and with the same
     weights in f32, against f32 on the CPU (plain versions): prefill and one
     decode step's logits, and the number of greedy tokens that agree;
  6. a JSON ``kernels`` line: per kernel at its serving path's shapes its
     launches in phase 4, its time, its plain version's time, one PyTorch
     call's time where one computes the same function (the attention
     kernels: F.scaled_dot_product_attention, a yardstick the port never
     calls) and the least time the card could take (bound_ms).  ``ms``,
     ``plain_ms`` and ``library_ms`` are CUDA-event means over 30
     back-to-back Python calls, so they include the host's time per call
     where it exceeds the device's; ``device_ms`` (and ``library_device_ms``
     for the PyTorch call) is the device's own time per call, the durations
     of the device kernels the calls launched, from a torch.profiler trace
     of a second pass of the same 30 calls (``device_ms_source``).  The two
     attention kernels serve smollm-135m and zamba2-1.2b at different head
     layouts; their entries carry the zamba2 shapes' numbers under "zamba2".
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails before printing any
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
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
#: card (f32, TF32 off) vs CPU (f32): the same math summed in another order,
#: ~1e-7 relative per rounding; ~1e-5 of the logit scale after the layers,
#: so 1e-3 leaves two orders of magnitude.
ENGINE_F32_REL_TOL = 1e-3
MIX = ["--device", "cuda", "--slots", "8", "--max-len", "2048", "--requests", "16",
       "--prompt-len", "32", "701", "--min-new", "32", "--max-new", "65", "--seed", "0"]
SMOLLM, ZAMBA2 = "smollm-135m", "zamba2-1.2b"
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
    call by kernel name); raises if the trace holds no such device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for x in inputs[:3]:
        fn(*x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and (not names or any(n in e.name for n in names))]
    if not events:
        raise AssertionError(f"device time: the profiler recorded no device kernel {names}")
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


def phase_vs_cpu(torch, res, Engine, EngineConfig, Request, bundle, tree_map):
    """The card's bf16 run and the same weights in f32 on the card, each
    against f32 on the CPU (plain versions): the f32 pair shows what the
    port computes, the bf16 pair adds bf16 rounding."""
    mb, params = res["bundle"], res["params"]
    log(f"{mb.cfg.name} on the card vs the same weights in f32 on the CPU:")
    mb32 = bundle(dataclasses.replace(mb.cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float().cpu(), params)
    prompt = list(map(int, np.random.default_rng(7).integers(1, mb.cfg.vocab_size, size=100)))
    n_new = 24
    runs = {}  # (bundle, params, device) -> (prefill logits, decode logits, greedy tokens)
    for key, b_, p_, dev in (("cpu f32", mb32, params32, "cpu"),
                             ("card bf16", mb, params, "cuda"),
                             ("card f32", mb32, tree_map(lambda t: t.cuda(), params32), "cuda")):
        toks = torch.tensor([prompt], device=dev)
        with torch.no_grad():
            lg, cg = b_.prefill_fn(p_, {"tokens": toks}, max_len=256)
            nxt = runs["cpu f32"][0][0, -1].argmax().view(1, 1) if runs else \
                torch.argmax(lg[0, -1]).view(1, 1)
            dg, _ = b_.decode_fn(p_, cg, nxt.to(dev), torch.tensor(len(prompt), device=dev))
        eng = Engine(b_, p_, EngineConfig(max_slots=2, max_len=256))
        eng.submit(Request(rid="g", prompt=prompt, max_new_tokens=n_new))
        runs[key] = (lg.cpu(), dg.cpu(), eng.run()[0].tokens)
        del p_, eng
    lc, dc, tc = runs["cpu f32"]
    for key, tol in (("card bf16", ENGINE_REL_TOL), ("card f32", ENGINE_F32_REL_TOL)):
        lg, dg, tg = runs[key]
        for label, got, want in (("prefill", lg, lc), ("decode step", dg, dc)):
            err = max_err(got, want)
            scale = float(want.abs().max())
            log(f"  {key} vs cpu f32 {label} logits: max_abs_err={err:.3e}, "
                f"max|logit|={scale:.3f}, rel={err / scale:.3e} tol={tol:g}")
            if err > tol * scale:
                raise AssertionError(f"{key} {label} logits disagree with the CPU")
        agree = next((i for i, (a, b) in enumerate(zip(tg, tc)) if a != b), n_new)
        log(f"  {key} vs cpu f32 greedy tokens agreeing before the first difference: "
            f"{agree} of {n_new}")


def bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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
    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    per_set = sum(math.prod(x) for x in shapes) * 2 + b * s * hq * d * 2
    sets = [tuple(torch.randn(x, generator=gen, device="cuda").to(torch.bfloat16)
                  for x in shapes) for _ in range(copies_past_l2(per_set))]
    pairs = s * (s + 1) // 2  # causal (q, k) pairs per head
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
        **bound(per_set, 2 * b * hq * pairs * (d + d)),
    )


def time_decode(torch, F, ref, dec, gen, lens, hq, hkv, d=64, smax=2048):
    """decode_attention on bf16 q (B,1,hq,d) against a (B,smax,hkv,d) cache
    at per-slot lengths ``lens``; bytes count only the rows up to each length."""
    bsz = len(lens)
    shapes = ((bsz, 1, hq, d), (bsz, smax, hkv, d), (bsz, smax, hkv, d))
    per_set = sum(lens) * hkv * (d + d) * 2 + 2 * bsz * hq * d * 2 + bsz * 4
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
        **bound(per_set, 2 * hq * sum(lens) * (d + d)),
    )


def phase_timing(torch, F, ref, _build, fa, dec, q8, ssd, runs):
    """Each kernel at its serving path's shapes.  The attention kernels run on
    two paths with different head layouts, so their entries also carry the
    zamba2-1.2b shapes (``zamba2``, with that run's launches)."""
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
    kv_bytes = sum(lens) * hkv * ((d + d) * 1 + 2 * 4)  # int8 rows + f32 scales
    per_set = kv_bytes + 2 * bsz * hq * d * 2 + bsz * 4
    n_sets = copies_past_l2(bsz * smax * hkv * (d * 2 + 8))

    def q8_set():
        kq, ks = ref.quantize_kv(torch.randn((bsz, smax, hkv, d), generator=gen, device="cuda"))
        vq, vs = ref.quantize_kv(torch.randn((bsz, smax, hkv, d), generator=gen, device="cuda"))
        return (torch.randn((bsz, 1, hq, d), generator=gen, device="cuda").to(bf), kq, ks, vq, vs)

    sets = [q8_set() for _ in range(n_sets)]
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
        **bound(per_set, 2 * hq * sum(lens) * (d + d)),
    ))
    del sets

    # --- SSD scan at the longest zamba2 prefill of the run ------------------
    h, p, n = zcfg.ssm_heads, zcfg.ssm_expand * zcfg.d_model // zcfg.ssm_heads, zcfg.ssm_state
    s = max(len(r.prompt) for r in z_reqs)  # recurrent prefills run at their exact length
    b = 1
    per_set = (b * s * h * p * 2 * 2 + b * s * h * 4 + h * 4 + b * s * n * 2 * 2
               + b * h * p * n * 4 * 2)  # x, y; dt; A; B, C; h0, hT
    n_sets = copies_past_l2(per_set)
    sets = [ssd_inputs(torch, gen, bf, b, s, h, p, n)
            + (torch.zeros((b, h, p, n), device="cuda"),) for _ in range(n_sets)]
    tile = 64  # the kernel's time tile
    pairs = sum(c * (c + 1) // 2 for c in [tile] * (s // tile) + ([s % tile] if s % tile else []))
    # C.B per chunk pair (shared by the heads), w @ x, and per step C h^T plus
    # the state update (2 P N each), per head
    flops = b * (2 * pairs * n + h * (2 * pairs * p + 4 * s * p * n))
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
    entries.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:81",
        shape=f"x({b},{s},{h},{p}) bf16, B/C({b},{s},{n}) bf16, dt f32, h0 zeros f32",
        launches=z_counts.get("ssd_scan", 0), launches_path=ZAMBA2,
        max_abs_err=max(max_err(y, wy), max_err(hT, wh)),
        ms=time_ms(lambda *a: ssd.ssd_scan_cuda(*a), sets),
        plain_ms=time_ms(lambda *a: ref.ssd_scan_ref(*a), sets, iters=3),
        library_ms=None,  # no single PyTorch call computes a selective scan
        body=ssd.body(*sets[0][:1], *sets[0][3:5]),
        **simt_times(ssd_simt, ("ssd_kernel<",), wy, sets),
        **device_times(lambda *a: ssd.ssd_scan_cuda(*a),
                       ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel",
                        "ssd_kernel"), None, sets),
        **bound(per_set, flops),
    ))
    del sets

    # the int8 decode reads about half the bf16 decode's bytes at the same lengths
    entries[2]["device_ms_vs_bf16_decode"] = entries[2]["device_ms"] / entries[1]["device_ms"]
    for e in entries:
        e["launches_by_path"] = {k: v[e["name"]] for k, v in by_path.items()}
        e["kernel_ms"] = e["ms"]
    return entries


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
    from repro_torch.launch import serve
    from repro_torch.models import bundle, layers
    from repro_torch.serving import Engine, EngineConfig, Request
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    phase_build(_build)
    phase_kernels(torch, ops, ref, fa, dec, q8, ssd)
    runs = phase_engines(torch, ops, serve, layers)
    for arch in (SMOLLM, ZAMBA2):
        phase_vs_cpu(torch, runs[arch][0], Engine, EngineConfig, Request, bundle, tree_map)
    entries = phase_timing(torch, F, ref, _build, fa, dec, q8, ssd, runs)
    for e in entries:
        for path, t in [(e["launches_path"], e)] + ([(ZAMBA2, e["zamba2"])] if "zamba2" in e
                                                     else []):
            lib = "none" if t["library_ms"] is None else (
                f"{t['library_ms']:.4f} ms, device {t['library_device_ms']:.4f} ms")
            log(f"  {e['name']} {t['shape']}: {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms "
                f"({t['device_ms_source']}; bound {t['bound_ms']:.5f} ms by {t['bound_by']}, "
                f"plain {t['plain_ms']:.4f} ms, library {lib}"
                + (f", CUDA-core body device {t['simt_device_ms']:.4f} ms" if "simt_device_ms" in t
                   else "") + f"), {t['launches']} launches in the {path} run")
    for arch, (res, _, _) in runs.items():
        log(f"  engine {arch}: {res['tok_per_s']:.1f} tok/s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
