"""``kvcache.live_share`` in a closed-loop cell, which judges its token gaps
(``itl_p95_ms``) and records its rate: the same reading."""


def read(ctx):
    return ctx.read("kvcache.live_share")
