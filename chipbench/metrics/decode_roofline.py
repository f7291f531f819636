"""Kernels (``kernels/csrc/decode_attention.cu``: the split-K pass and its
combine): the decode attention launches inside the profiler slice's decode
forwards, their roofline bound summed over their summed device time, in
percent.  The bound is the frozen ``chipbench/cost.py`` over the active
slots alone, each at its length (clamped to the window's ring): the rows
the step needs.  What the kernels spend on the idle slots' rows counts in
their time and not in the bound."""
import torch

from chipbench import trace
from chipbench.harness import DECODE
from chipbench.metrics._common import DECODE_ATTN, device_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    c, rec = ctx.config, ctx.record
    h, kv = c["n_heads"], c["n_kv_heads"]
    hd = c.get("head_dim") or c["d_model"] // h
    smax = min(rec.max_len, c["sliding_window"]) if c.get("sliding_window") else rec.max_len
    active = {sp[3]: [s.kernel_lengths[i] for i in sorted(s.decode_slots)]
              for s in rec.steps for sp in s.spans if sp[0] == DECODE}
    bound = secs = 0.0
    for n, acts in trace.inside(ctx.trace, DECODE).items():
        attn = [a for a in acts if DECODE_ATTN.search(a[0])]
        launches = sum(1 for a in attn if "split" in a[0])
        if not attn or not active.get(n):
            continue
        b = len(active[n])
        q = torch.empty((b, 1, h, hd), dtype=torch.bfloat16, device="meta")
        k = torch.empty((b, smax, kv, hd), dtype=torch.bfloat16, device="meta")
        w = ctx.cost.decode_attention(q, k, k, active[n])
        bound += launches * max(w.flops / ctx.peaks["bf16_flops_per_s"],
                                w.bytes / ctx.peaks["hbm_bytes_per_s"])
        secs += device_seconds(attn)
    return 100.0 * bound / secs if secs else None
