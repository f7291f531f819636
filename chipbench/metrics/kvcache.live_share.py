"""KV cache (``serving/kvcache.py``, the ragged cache of ``max_slots`` x
``max_len`` rows): the mean over the window's decode steps of the rows
the active slots hold over the rows allocated."""
from chipbench import stats


def read(ctx):
    rec = ctx.record
    total = rec.max_slots * rec.max_len
    share = [sum(s.kernel_lengths[i] for i in s.decode_slots) / total
             for s in rec.window_steps() if s.decode_slots]
    return stats.mean(share) if share else None
