"""Median time of the program's ``http /lbm/frame`` span over the frames of
the traced slice, in milliseconds: the server's own part of a round trip,
from the route's dispatch to the reply written (the body's read and
parse, the handler, the reply's JSON and its write). Read from the
profiler's host records that lie inside the slice; None without a trace
or without such a span (a program that does not span its requests)."""

from statistics import median

SPAN = "http /lbm/frame"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    times = [e - s for s, e, name in t.host
             if name == SPAN and t.begin_us <= s and e <= t.end_us]
    return median(times) / 1e3 if times else None
