"""MoE (``models/moe.py``): the median, over the window's decode forwards
that the profiler's slice did not slow down, of the host time inside that
forward's ``moe.route`` and ``moe.experts`` spans (the router and the
expert layer; the program's own spans, a traced run's live handle).
Nothing where the run kept no program records, the tracer dropped some,
or the program records no MoE span."""
import bisect

from chipbench import stats
from chipbench.metrics._common import span_outside_trace

MOE_SPANS = ("moe.route", "moe.experts")


def read(ctx):
    rec = ctx.record
    prog = rec.program
    if prog is None or prog.n_dropped:
        return None
    moe = sorted((s.t_start, s.t_end) for s in prog.spans if s.name in MOE_SPANS)
    if not moe:
        return None
    starts = [a for a, _ in moe]
    ms = []
    for s in prog.spans:
        if (s.name == "model.forward" and s.attrs.get("mode") == "decode"
                and rec.t_open <= s.t_start and s.t_end <= rec.t_close
                and span_outside_trace(ctx, s.t_start, s.t_end)):
            i, j = bisect.bisect_left(starts, s.t_start), bisect.bisect_right(starts, s.t_end)
            ms.append(sum(b - a for a, b in moe[i:j]) * 1e3)
    return stats.percentile(ms, 50) if ms else None
