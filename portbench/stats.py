"""The arithmetic of the end-to-end metrics: percentiles over all requests
of a window, and rates over the window's length."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value that at
    least ``q`` % of ``values`` do not exceed."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]


def window_bounds(sent_received) -> tuple[float, float]:
    """(open, close) of a window of (sent, received) stamps: it opens as
    the first request is sent and closes as the last one answers."""
    return (min(s for s, _ in sent_received),
            max(r for _, r in sent_received))
