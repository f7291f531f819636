"""Device (the H100): the share of the profiler's slice (host clock,
synchronized at both ends) in which no device activity ran."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]
