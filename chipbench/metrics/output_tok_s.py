"""Every output token the engine produced in the window, over the window's
seconds (host clock, from the window's first step start to its last step
end)."""


def read(ctx):
    rec = ctx.record
    n = sum(1 for r in rec.requests.values() for t in r.times if rec.t_open < t <= rec.t_close)
    return n / (rec.t_close - rec.t_open)
