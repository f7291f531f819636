"""Kernels (``kernels/csrc/flash_attention.cu``): the flash launches inside
the profiler slice's prefill forwards, their roofline bound (the larger of
FLOPs over the bf16 peak and bytes over HBM bandwidth, from the frozen
``chipbench/cost.py`` at each launch's shapes: the prefill's padded bucket,
causal, with the configuration's window) summed over their summed device
time, in percent."""
import torch

from chipbench import trace
from chipbench.harness import PREFILL
from chipbench.metrics._common import FLASH, device_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    c = ctx.config
    h, kv = c["n_heads"], c["n_kv_heads"]
    hd = c.get("head_dim") or c["d_model"] // h
    rows = {sp[3]: sp[4] for s in ctx.record.steps for sp in s.spans if sp[0] == PREFILL}
    bound = secs = 0.0
    for n, acts in trace.inside(ctx.trace, PREFILL).items():
        flash = [a for a in acts if FLASH.search(a[0])]
        if not flash or n not in rows:
            continue
        s = rows[n]
        q = torch.empty((1, s, h, hd), dtype=torch.bfloat16, device="meta")
        k = torch.empty((1, s, kv, hd), dtype=torch.bfloat16, device="meta")
        w = ctx.cost.flash_attention(q, k, k, True, c.get("sliding_window"))
        bound += len(flash) * max(w.flops / ctx.peaks["bf16_flops_per_s"],
                                  w.bytes / ctx.peaks["hbm_bytes_per_s"])
        secs += device_seconds(flash)
    return 100.0 * bound / secs if secs else None
