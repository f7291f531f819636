"""MoE (``models/moe.py``'s held-expert layer): its grouped GEMMs
(``torch._grouped_mm``'s CUTLASS kernels) inside the profiler slice's
prefill and decode forwards, against their roofline: per MoE layer of a
forward, 3 x 2 x rows x d_model x moe_d_ff FLOPs over the bf16 peak, or
the bytes over HBM bandwidth (each held expert that some row reached, its
three bf16 matrices; the rows in and out, d_model wide in bf16), whichever
is larger; rows: the (token, choice) pairs the recorded routing sends to
the held experts in that call (every row of the batch the forward ran:
the bucket's padding at prefill, every slot at decode).  The bound summed
over the forwards' summed kernel time, in percent.  Nothing where no such
kernel ran (a program without the layer)."""
import re

from chipbench import trace
from chipbench.harness import DECODE, PREFILL
from chipbench.metrics._common import device_seconds

GROUPED = re.compile(r"GroupProblemShape|prepare_grouped_gemm")
GEMM = re.compile(r"GroupProblemShape")


def _calls(rec):
    """Each prefill and decode forward's routing calls, by the harness's
    range number."""
    out = {}
    for i, s in enumerate(rec.steps):
        pre = [sp for sp in s.spans if sp[0] == PREFILL]
        for rid, sp in zip(s.admitted, pre):
            if rid in rec.prefill_routes:
                out[(PREFILL, sp[3])] = rec.prefill_routes[rid]
        for sp in s.spans:
            if sp[0] == DECODE and i in rec.decode_routes:
                out[(DECODE, sp[3])] = rec.decode_routes[i]
    return out


def read(ctx):
    c, rec = ctx.config, ctx.record
    if ctx.trace is None or not c.get("n_routed_experts"):
        return None
    d, f = c["d_model"], c["moe_d_ff"]
    lo, e = c.get("expert_offset", 0), c["n_experts"]
    calls = _calls(rec)
    bound = secs = 0.0
    for kind in (PREFILL, DECODE):
        for n, acts in trace.inside(ctx.trace, kind).items():
            grouped = [a for a in acts if GROUPED.search(a[0])]
            layers = calls.get((kind, n))
            # three GEMMs a layer, or the trace lost some of this forward's records
            if not layers or sum(1 for a in grouped if GEMM.search(a[0])) != 3 * len(layers):
                continue
            for sel in layers:
                held = sel[(sel >= lo) & (sel < lo + e)]
                rows = int(held.numel())
                touched = int(held.unique().numel())
                flops = 3 * 2 * rows * d * f
                nbytes = 2 * (touched * 3 * d * f + 2 * rows * d)
                bound += max(flops / ctx.peaks["bf16_flops_per_s"],
                             nbytes / ctx.peaks["hbm_bytes_per_s"])
            secs += device_seconds(grouped)
    return 100.0 * bound / secs if secs else None
