"""Median host time inside ``LBMSessions.frame`` over the window's frames,
in milliseconds: the step, the diagnostics, the copy back and the fields'
base64."""

from statistics import median


def read(ctx):
    spans = ctx.spans.get("LBMSessions.frame", [])
    return 1e3 * median([e - s for s, e in spans]) if spans else None
