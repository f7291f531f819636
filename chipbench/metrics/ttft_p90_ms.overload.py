"""``ttft_p90_ms`` in a cell offered more than the engine sustains: the
queue grows all through the window, so the tail mostly counts the backlog
and swings with the smallest change of speed.  Recorded, not judged."""


def read(ctx):
    return ctx.read("ttft_p90_ms")
