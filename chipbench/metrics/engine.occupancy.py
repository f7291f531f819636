"""Batching (``serving/engine.py``): the mean over the window's decode
steps of the slots active at the decode over ``max_slots``."""
from chipbench import stats


def read(ctx):
    rec = ctx.record
    occ = [len(s.decode_slots) / rec.max_slots for s in rec.window_steps() if s.decode_slots]
    return stats.mean(occ) if occ else None
