"""Median time of the program's ``lbm.frame`` span over the frames of the
traced slice, in milliseconds: the wind tunnel's frame, its LBM step's
launch and its diagnostics (the frame graph's replay and the three
scalars read back, where the host waits for the card). Read from the
profiler's host records that lie inside the slice; None without a trace
or without such a span."""

from statistics import median

SPAN = "lbm.frame"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    times = [e - s for s, e, name in t.host
             if name == SPAN and t.begin_us <= s and e <= t.end_us]
    return median(times) / 1e3 if times else None
