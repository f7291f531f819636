"""Model step, prefill (``models/``): useful prefill FLOPs (true tokens,
experts per token, causal attention; the kind's, ``chipbench/kinds/``) over the
synchronized seconds of the window's ``prefill_fn`` calls (traced run,
calls outside the profiler's slice) times the bf16 peak, in percent."""
from chipbench.harness import PREFILL
from chipbench.metrics._common import span_outside_trace


def read(ctx):
    rec = ctx.record
    work = secs = 0.0
    for s in rec.window_steps():
        spans = [sp for sp in s.spans if sp[0] == PREFILL]
        for rid, (_, t0, t1, _, _) in zip(s.admitted, spans):
            if span_outside_trace(ctx, t0, t1):
                work += ctx.flops.prefill_flops(rec.config, rec.requests[rid].prompt_len,
                                                image=bool(rec.mix.get("images")))
                secs += t1 - t0
    return 100.0 * work / (secs * ctx.peaks["bf16_flops_per_s"]) if secs else None
