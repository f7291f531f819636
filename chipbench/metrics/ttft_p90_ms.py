"""90th percentile of time to first token over every request due (open
loop) or sent (closed loop) in the window: from then to the end of the
engine step that yielded its first token.  A request with no token by the
window's close counts its wait so far, so a backlog shows."""
from chipbench import stats
from chipbench.metrics._common import ttft_s


def read(ctx):
    waits = ttft_s(ctx.record)
    return stats.percentile(waits, 90) * 1e3 if waits else None
