"""Kernels (``kernels/csrc/flash_attention.cu`` at MLA's shapes): the
flash launches inside the profiler slice's prefill forwards, their roofline
bound (the larger of FLOPs over the bf16 peak and bytes over HBM
bandwidth, from the frozen ``chipbench/cost.py``: q and k (1, bucket,
n_heads, nope + rope), v (1, bucket, n_heads, v_head_dim), causal) summed
over their summed device time, in percent.  The bound prices the head
size the model uses (192); the kernel's padding of it to 256 shows as lost
share.  Nothing for a configuration without MLA."""
import torch

from chipbench import trace
from chipbench.harness import PREFILL
from chipbench.metrics._common import FLASH, device_seconds


def read(ctx):
    c = ctx.config
    if ctx.trace is None or c.get("attention") != "mla":
        return None
    h, dv = c["n_heads"], c["v_head_dim"]
    dq = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    rows = {sp[3]: sp[4] for s in ctx.record.steps for sp in s.spans if sp[0] == PREFILL}
    bound = secs = 0.0
    for n, acts in trace.inside(ctx.trace, PREFILL).items():
        flash = [a for a in acts if FLASH.search(a[0])]
        if not flash or n not in rows:
            continue
        s = rows[n]
        q = torch.empty((1, s, h, dq), dtype=torch.bfloat16, device="meta")
        v = torch.empty((1, s, h, dv), dtype=torch.bfloat16, device="meta")
        w = ctx.cost.flash_attention(q, q, v, True, None)
        bound += len(flash) * max(w.flops / ctx.peaks["bf16_flops_per_s"],
                                  w.bytes / ctx.peaks["hbm_bytes_per_s"])
        secs += device_seconds(flash)
    return 100.0 * bound / secs if secs else None
