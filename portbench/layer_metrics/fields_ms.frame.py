"""Median time of the program's ``lbm.fields`` span over the frames of the
traced slice, in milliseconds: the requested fields' copies from the card
to the host and their base64. Read from the profiler's host records that
lie inside the slice; None without a trace or without such a span."""

from statistics import median

SPAN = "lbm.fields"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    times = [e - s for s, e, name in t.host
             if name == SPAN and t.begin_us <= s and e <= t.end_us]
    return median(times) / 1e3 if times else None
