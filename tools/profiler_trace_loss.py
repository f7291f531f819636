"""How often a torch.profiler session on the card records no device kernel.

``chip_smoke.py`` phase 6 reads each kernel's device time from a fresh
``torch.profiler`` session over 30 calls.  This script opens the same kind
of session many times over two plain calls (a 512 x 512 f32 matmul and
bf16 SDPA at smollm-135m's decode shape), synchronizing before the session
and inside it before it ends, in two variants: as phase 6 does it ("base"),
and with a 2 ms sleep before the session ends ("sleep").  For every session
whose events hold no device kernel it prints what the session did hold: the
raw Kineto result's device records and the CPU-side events (launches).

  python3 tools/profiler_trace_loss.py [--sessions 1200]

Needs one CUDA device; prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
import warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=1200)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_trace_loss: needs a CUDA device", file=sys.stderr)
        return 1
    # torch 2.11 warns "Profiler clears events at the end of each cycle" on
    # every fresh session (prepare_trace tests the profiler it just created)
    warnings.filterwarnings("ignore", message=".*clears events.*")
    q = torch.randn(8, 9, 1, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(8, 9, 2048, 64, device="cuda", dtype=torch.bfloat16)
    a = torch.randn(512, 512, device="cuda")
    fns = {"sdpa": lambda: F.scaled_dot_product_attention(q, k, k), "mm": lambda: a @ a}
    cuda = torch.autograd.DeviceType.CUDA

    def session(fn, variant):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(30):
                fn()
            torch.cuda.synchronize()
            if variant == "sleep":
                time.sleep(0.002)
        events = prof.events()
        if any(e.device_type == cuda for e in events):
            return None
        raw = prof.profiler.kineto_results.events()
        cpu = collections.Counter(e.name for e in events)
        return {"events": len(events), "raw_events": len(raw),
                "raw_device_events": sum(e.device_type() == cuda for e in raw),
                "launch_events": sum(v for n, v in cpu.items() if "Launch" in n)}

    empty = collections.defaultdict(list)
    count = collections.Counter()
    t0 = time.perf_counter()
    for i in range(args.sessions):
        variant, name = ("base", "sleep")[i % 2], ("mm", "mm", "sdpa", "sdpa")[i % 4]
        count[variant] += 1
        got = session(fns[name], variant)
        if got is not None:
            empty[variant].append({"session": i, "fn": name, **got})
            print(f"session {i} ({variant}, {name}): no device kernel; {got}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__,
                      "sessions": dict(count), "seconds": time.perf_counter() - t0,
                      "empty": {v: empty[v] for v in count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
