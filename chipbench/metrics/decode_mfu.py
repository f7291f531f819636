"""Model step, decode (``models/``): useful FLOPs of the window's decode
forwards (one token per active slot at its position; the kind's count) over
their synchronized seconds (traced run, outside the profiler's slice)
times the bf16 peak, in percent."""
from chipbench.harness import DECODE
from chipbench.metrics._common import span_outside_trace


def read(ctx):
    rec = ctx.record
    work = secs = 0.0
    for s in rec.window_steps():
        for _, t0, t1, _, _ in (sp for sp in s.spans if sp[0] == DECODE):
            if span_outside_trace(ctx, t0, t1):
                pos = [s.kernel_lengths[i] - 1 for i in s.decode_slots]
                work += ctx.flops.decode_flops(rec.config, pos)
                secs += t1 - t0
    return 100.0 * work / (secs * ctx.peaks["bf16_flops_per_s"]) if secs else None
