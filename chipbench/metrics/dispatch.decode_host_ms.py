"""Dispatch (``kernels/ops.py`` and the eager torch ops around it): the
median host time of the window's decode forwards, from the program's own
``model.forward`` spans (``mode`` "decode"; a traced run's live handle),
those the profiler's slice did not slow down: the host's time inside one
decode forward, issuing its launches and waiting wherever the forward
itself waits for the device (the harness's synchronizes lie outside the
span).  Nothing where the run kept no program records or the tracer
dropped some."""
from chipbench import stats
from chipbench.metrics._common import span_outside_trace


def read(ctx):
    rec = ctx.record
    prog = rec.program
    if prog is None or prog.n_dropped:
        return None
    ms = [(s.t_end - s.t_start) * 1e3 for s in prog.spans
          if s.name == "model.forward" and s.attrs.get("mode") == "decode"
          and rec.t_open <= s.t_start and s.t_end <= rec.t_close
          and span_outside_trace(ctx, s.t_start, s.t_end)]
    return stats.percentile(ms, 50) if ms else None
