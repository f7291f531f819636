"""``itl_p95_ms`` in a cell offered more than the engine sustains, where
every step admits what its free slots take: recorded, not judged."""


def read(ctx):
    return ctx.read("itl_p95_ms")
