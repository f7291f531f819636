"""Dispatch (``kernels/ops.py`` and the eager torch ops around it): device
kernels (copies and sets left out) that started inside the decode forwards
of the profiler's slice, per decode forward."""
from chipbench import trace
from chipbench.harness import DECODE
from chipbench.metrics._common import COPY


def read(ctx):
    if ctx.trace is None:
        return None
    per = trace.inside(ctx.trace, DECODE)
    if not per:
        return None
    n = sum(1 for acts in per.values() for a in acts if not COPY.match(a[0]))
    return n / len(per)
