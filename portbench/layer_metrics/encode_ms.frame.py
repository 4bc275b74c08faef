"""Median time of the program's ``http.encode`` span (the reply's
``json.dumps`` and its encoding to bytes) over the ``/lbm/frame``
replies of the traced slice, in milliseconds. An encode counts where it
lies inside an ``http /lbm/frame`` span, by time (the host records carry
no thread): other routes' replies are left out. Read from the profiler's
host records that lie inside the slice; None without a trace or without
such a span."""

from statistics import median

SPAN, REQUEST = "http.encode", "http /lbm/frame"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    inside = [(s, e, name) for s, e, name in t.host
              if name in (SPAN, REQUEST) and t.begin_us <= s
              and e <= t.end_us]
    requests = [(s, e) for s, e, name in inside if name == REQUEST]
    times = [e - s for s, e, name in inside if name == SPAN
             and any(rs <= s and e <= re for rs, re in requests)]
    return median(times) / 1e3 if times else None
