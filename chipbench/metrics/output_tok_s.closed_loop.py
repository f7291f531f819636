"""``output_tok_s`` in a closed-loop cell, a client a slot and every slot
held: the rate there is the host's pace of issuing decode steps, which
moves from run to run with the host's speed, so the cell judges its token
gaps and its time to first token and records this."""


def read(ctx):
    return ctx.read("output_tok_s")
