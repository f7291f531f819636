#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):
  1. the device, as nvidia-smi reports its name and power limit;
  2. build every kernel of the serving path from kernels/csrc (nvcc, all
     sources at once) and print the compiler's register/spill summary;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes and at the reference test sweeps, within the
     stated tolerance (bf16 2e-2, f32 2e-5, as atol and rtol);
  4. the engine at full width: smollm-135m in bf16 with seeded random
     weights serves 16 seeded requests through repro_torch.launch.serve's
     engine path; the kernels' launch counts are zeroed just before and read
     just after, and both kernels must have launched;
  5. the engine on the card against the same weights in f32 on the CPU
     (plain versions): prefill and one decode step's logits, and the number
     of greedy tokens that agree;
  6. a JSON ``kernels`` line: per kernel at the serving path's shapes its
     launches in phase 4, its time, its plain version's time, one PyTorch
     call's time (F.scaled_dot_product_attention, a yardstick the port never
     calls) and the least time the card could take (bound_ms).
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails before printing any
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: card (bf16) vs CPU (f32) logits: bf16 keeps 8 significant bits, about
#: 0.2% per rounding; ~12 roundings per layer over 30 layers random-walk to
#: ~4% of the logit scale, so allow 10% of the largest reference logit.
ENGINE_REL_TOL = 0.1
SERVE_ARGS = ["--arch", "smollm-135m", "--device", "cuda", "--slots", "8", "--max-len", "2048",
              "--requests", "16", "--prompt-len", "32", "701", "--min-new", "32",
              "--max-new", "65", "--seed", "0"]
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(label: str, got, want, dtype_name: str) -> float:
    import torch

    tol = TOL[dtype_name]
    err = max_err(got, want)
    ok = bool(torch.all((got.float() - want.float()).abs() <= tol + tol * want.float().abs()))
    log(f"  {label}: max_abs_err={err:.3e} tol(atol=rtol)={tol:g} {'ok' if ok else 'FAIL'}")
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
    secs = _build.build(["flash_attention", "decode_attention"])
    log(f"build: {time.perf_counter() - t0:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in secs.items()) or 'cached'})")
    for lib in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in lib.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {lib.stem}: {line.strip()}")


def phase_kernels(torch, ref, fa, dec):
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    flash_cases = [
        # (label, dtype, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window)
        ("smollm prefill S=512", "bfloat16", 1, 512, 512, 9, 3, 64, 64, True, None),
        ("smollm prefill S=1024", "bfloat16", 1, 1024, 1024, 9, 3, 64, 64, True, None),
        ("odd S=300", "bfloat16", 1, 300, 300, 9, 3, 64, 64, True, None),
        ("odd S=300", "float32", 1, 300, 300, 9, 3, 64, 64, True, None),
        ("Sq<Sk 100/300", "float32", 2, 100, 300, 8, 2, 64, 64, True, None),
        ("Sq>Sk non-causal 150/77", "float32", 2, 150, 77, 6, 2, 64, 64, False, None),
        ("Dv!=D non-causal", "float32", 1, 77, 150, 4, 4, 128, 256, False, None),
        ("window 32", "float32", 2, 256, 256, 4, 2, 64, 64, True, 32),
        ("window 100", "float32", 2, 256, 256, 4, 2, 64, 64, True, 100),
        ("window 256", "float32", 2, 256, 256, 4, 2, 64, 64, True, 256),
        ("non-causal MHA", "float32", 1, 128, 128, 4, 4, 64, 64, False, None),
    ]
    for dn in ("float32", "bfloat16"):  # tests/test_kernels.py flash sweep
        for b, s, hq, hkv, d in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 6, 1, 32),
                                 (2, 128, 4, 2, 80)]:
            flash_cases.append((f"sweep {b}x{s}x{hq}/{hkv}x{d}", dn, b, s, s, hq, hkv, d, d,
                                True, None))
    log("kernels vs plain versions on the card:")
    for label, dn, b, sq, sk, hq, hkv, d, dv, causal, win in flash_cases:
        q, k, v = rn((b, sq, hq, d), dts[dn]), rn((b, sk, hkv, d), dts[dn]), rn((b, sk, hkv, dv), dts[dn])
        got = fa.flash_attention_cuda(q, k, v, causal, win)
        torch.cuda.synchronize()
        check_close(f"flash_attention {label} {dn}", got, ref.attention_ref(q, k, v, causal, win), dn)
    dec_cases = [
        ("smollm 8 slots, Smax=2048", "bfloat16", 8, 2048, 9, 3, 64,
         [1, 2048, 3000, 5, 700, 64, 65, 128]),
        ("smollm 8 slots, Smax=2048", "float32", 8, 2048, 9, 3, 64,
         [1, 2048, 2049, 5, 700, 64, 65, 128]),
        ("ragged", "float32", 4, 256, 8, 2, 64, [1, 64, 137, 256]),
    ]
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


def phase_engine(torch, ops, serve):
    log("engine at full width: " + " ".join(SERVE_ARGS))
    args = serve.parse_args(SERVE_ARGS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = serve.run_engine(args)
    counts = ops.launch_counts()
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
    for name in ("flash_attention", "decode_attention"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the serving path")
    return res, counts, reqs


def phase_vs_cpu(torch, res, Engine, EngineConfig, Request, bundle, tree_map):
    mb, params = res["bundle"], res["params"]
    cfg32 = dataclasses.replace(mb.cfg, dtype="float32")
    mb32 = bundle(cfg32)
    params32 = tree_map(lambda t: t.float().cpu(), params)
    prompt = list(map(int, np.random.default_rng(7).integers(1, mb.cfg.vocab_size, size=100)))
    toks = torch.tensor([prompt])
    with torch.no_grad():
        lg, cg = mb.prefill_fn(params, {"tokens": toks.cuda()}, max_len=256)
        lc, cc = mb32.prefill_fn(params32, {"tokens": toks}, max_len=256)
        nxt = torch.argmax(lg[0, -1]).view(1, 1)
        dg, _ = mb.decode_fn(params, cg, nxt.cuda(), torch.tensor(len(prompt), device="cuda"))
        dc, _ = mb32.decode_fn(params32, cc, nxt.cpu(), torch.tensor(len(prompt)))
    worst = 0.0
    for label, got, want in (("prefill", lg, lc), ("decode step", dg, dc)):
        err = max_err(got.cpu(), want)
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        log(f"  card bf16 vs cpu f32 {label} logits: max_abs_err={err:.4f}, max|logit|={scale:.3f}, "
            f"rel={err / scale:.4f} tol={ENGINE_REL_TOL}")
        if err > ENGINE_REL_TOL * scale:
            raise AssertionError(f"{label} logits on the card disagree with the CPU")
    n_new = 24
    outs = []
    for p, dev in ((params, "cuda"), (params32, "cpu")):
        eng = Engine(mb if dev == "cuda" else mb32, p, EngineConfig(max_slots=2, max_len=256))
        eng.submit(Request(rid="g", prompt=prompt, max_new_tokens=n_new))
        outs.append(eng.run()[0].tokens)
    agree = next((i for i, (a, b) in enumerate(zip(*outs)) if a != b), n_new)
    log(f"  greedy tokens agreeing before the first difference: {agree} of {n_new}")
    return worst, agree


def phase_timing(torch, F, ref, fa, dec, counts, reqs):
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    entries = []

    # --- flash attention at the largest prefill bucket of the run ---------
    s = max(1 << (len(r.prompt) - 1).bit_length() for r in reqs)
    b, hq, hkv, d = 1, 9, 3, 64
    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    per_set = sum(math.prod(x) for x in shapes) * 2 + b * s * hq * d * 2
    sets = [tuple(torch.randn(x, generator=gen, device="cuda").to(bf) for x in shapes)
            for _ in range(copies_past_l2(per_set))]
    pairs = s * (s + 1) // 2  # causal (q, k) pairs per head
    flops = 2 * b * hq * pairs * (d + d)
    q, k, v = sets[0]
    entries.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:90",
        shape=f"q({b},{s},{hq},{d}) kv({b},{s},{hkv},{d}) bf16 causal",
        launches=counts.get("flash_attention", 0),
        max_abs_err=max_err(fa.flash_attention_cuda(q, k, v, True), ref.attention_ref(q, k, v, True)),
        ms=time_ms(lambda q, k, v: fa.flash_attention_cuda(q, k, v, True), sets),
        plain_ms=time_ms(lambda q, k, v: ref.attention_ref(q, k, v, True), sets),
        library_ms=time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True), sets),
        bytes=per_set, flops=flops,
    ))

    # --- decode attention: 8 slots mid-generation of the run's requests ----
    bsz, smax = 8, 2048
    lens = [len(r.prompt) + r.max_new_tokens // 2 for r in reqs[:bsz]]
    shapes = ((bsz, 1, hq, d), (bsz, smax, hkv, d), (bsz, smax, hkv, d))
    kv_bytes = sum(lens) * hkv * (d + d) * 2
    per_set = kv_bytes + 2 * bsz * hq * d * 2 + bsz * 4
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(smax, device="cuda")[None, :] < length[:, None])[:, None, None, :]
    n_sets = copies_past_l2(bsz * smax * hkv * d * 2 * 2)
    sets = [tuple(torch.randn(x, generator=gen, device="cuda").to(bf) for x in shapes)
            for _ in range(n_sets)]
    q, k, v = sets[0]
    entries.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:71",
        shape=f"q({bsz},1,{hq},{d}) cache({bsz},{smax},{hkv},{d}) bf16 lengths {lens}",
        launches=counts.get("decode_attention", 0),
        max_abs_err=max_err(dec.decode_attention_cuda(q, k, v, length),
                            ref.decode_attention_ref(q, k, v, length)),
        ms=time_ms(lambda q, k, v: dec.decode_attention_cuda(q, k, v, length), sets),
        plain_ms=time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, length), sets),
        library_ms=time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True), sets),
        bytes=per_set, flops=2 * hq * sum(lens) * (d + d),
    ))
    for e in entries:
        t_bytes = e["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = e["flops"] / BF16_FLOPS * 1e3
        e["bound_ms"] = max(t_bytes, t_ops)
        e["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
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

    from repro_torch.kernels import _build, decode_attention as dec, flash_attention as fa, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import bundle
    from repro_torch.serving import Engine, EngineConfig, Request
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    phase_build(_build)
    phase_kernels(torch, ref, fa, dec)
    res, counts, reqs = phase_engine(torch, ops, serve)
    log("engine on the card vs the same weights in f32 on the CPU:")
    phase_vs_cpu(torch, res, Engine, EngineConfig, Request, bundle, tree_map)
    entries = phase_timing(torch, F, ref, fa, dec, counts, reqs)
    for e in entries:
        log(f"  {e['name']}: {e['ms']:.4f} ms (bound {e['bound_ms']:.5f} ms by {e['bound_by']}, "
            f"plain {e['plain_ms']:.4f} ms, sdpa {e['library_ms']:.4f} ms), "
            f"{e['launches']} launches in the engine run")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
