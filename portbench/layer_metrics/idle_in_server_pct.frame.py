"""Share of the traced slice's device-idle time that lies inside the
program's ``http /lbm/frame`` spans, in percent: the card's wait that the
server's own host work accounts for (the body's read, the handler, the
reply's JSON and its write). The rest of the idle time is the client's
and the socket's. The spans are cut to the slice; None without a trace,
without such a span or without idle time."""

SPAN = "http /lbm/frame"


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    server = _union((max(s, t.begin_us), min(e, t.end_us))
                    for s, e, name in t.host
                    if name == SPAN and e > t.begin_us and s < t.end_us)
    if not server:
        return None
    edges = [t.begin_us]
    for s, e in t.busy_intervals():
        edges += [s, e]
    edges.append(t.end_us)
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_us = sum(e - s for s, e in idle)
    if idle_us <= 0:
        return None
    both, j = 0.0, 0
    for s, e in idle:              # both lists sorted and disjoint
        while j < len(server) and server[j][1] <= s:
            j += 1
        k = j
        while k < len(server) and server[k][0] < e:
            both += min(e, server[k][1]) - max(s, server[k][0])
            k += 1
    return 100.0 * both / idle_us
