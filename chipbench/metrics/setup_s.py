"""Process start to the window's opening: imports, the device context, the
kernels' build (first run in a checkout only), the seeded weights, the
engine and its cache, one warm-up prefill per bucket, and the pre-roll
that brings the engine to its steady load."""


def read(ctx):
    return ctx.setup_s
