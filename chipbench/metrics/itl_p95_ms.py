"""95th percentile of every gap between consecutive output tokens of a
request, over the gaps that end in the window.  A request's first two
tokens arrive at the end of the same step (its prefill's token and its
first decode), a gap of 0, as the user sees them.  A window holds some
tens of thousands of gaps; the steps that carry a prefill hold more than a
tenth of them, so p95 lies inside that kind of step and not on the edge
between it and a decode-only step."""
from chipbench import stats
from chipbench.metrics._common import gaps_s


def read(ctx):
    gaps = gaps_s(ctx.record)
    return stats.percentile(gaps, 95) * 1e3 if gaps else None
