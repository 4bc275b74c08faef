"""Multi-element airfoil detection.

Single-element panel codes (XFOIL, and this framework's panel solver) cannot
analyse multi-element high-lift systems; the reference's benchmark detects
them by counting trailing-edge -> leading-edge passes in the coordinate trace
(reference benchmark/airfoil_parser_benchmark.py:300-326) and reports them as
out-of-scope rather than as failures. Here the check is promoted to a
first-class validation used by the API layer.

A copy of ``airfoil_tpu/geometry/multielement.py``.
"""

from __future__ import annotations

__all__ = ["count_le_passes", "is_multi_element"]


def count_le_passes(
    coords, le_thresh: float = 0.05, te_thresh: float = 0.90
) -> int:
    """Count TE->LE->TE traversals of the coordinate trace.

    A single-element airfoil descends from the trailing edge to the leading
    edge and returns exactly once. Each additional closed loop (slat, flap)
    adds another pass.
    """
    passes = 0
    state = "start"
    for pt in coords:
        x = pt[0]
        if x <= le_thresh and state in ("start", "high"):
            state = "low"
        elif x >= te_thresh and state == "low":
            passes += 1
            state = "high"
    return passes


def is_multi_element(coords) -> bool:
    """True if the file appears to contain more than one airfoil element."""
    return count_le_passes(coords) >= 2
