"""Admission wait (``serving/engine.py``): 90th percentile over the
requests due or sent in the window of the time from then to the start of
the step that admitted (prefilled) it; a request not admitted by the close
counts its wait so far."""
from chipbench import stats
from chipbench.metrics._common import sent_in_window


def read(ctx):
    rec = ctx.record
    waits = []
    for r in sent_in_window(rec):
        end = r.admitted if r.admitted is not None and r.admitted <= rec.t_close else rec.t_close
        waits.append(end - r.sent)
    return stats.percentile(waits, 90) * 1e3 if waits else None
