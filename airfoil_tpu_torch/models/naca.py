"""Analytic airfoil shapes: copies of ``naca4``, ``clark_y`` and ``SHAPES``
from ``airfoil_tpu/models/naca.py`` (NumPy), kept so that the port imports
nothing of the JAX package. Each returns a Selig-ordered loop (TE -> upper
-> LE -> lower -> TE).
"""

from __future__ import annotations

import numpy as np

__all__ = ["naca4", "clark_y", "SHAPES"]


def naca4(m: float, p: float, t: float, n: int = 50,
          closed_te: bool = False) -> np.ndarray:
    """Generate a NACA 4-digit airfoil as a Selig-ordered (2n+1, 2) array.

    Parameters use the digit convention: ``m`` = max camber in % chord,
    ``p`` = camber position in tenths of chord, ``t`` = thickness in % chord.
    Cosine-spaced in x. Matches the standard equations (also used at
    reference html:99-116).

    By default the STANDARD open trailing edge is generated (x^4
    coefficient -0.1015, TE gap 0.0021 t), matching the geometry behind
    the published XFOIL polars the parity harness anchors on (XFOIL's own
    NACA generator is open-TE) — a closed sharp TE forces an inviscid
    TE stagnation that steepens the aft recovery and, at high alpha,
    blows the laminar lower-side TE displacement into a spurious
    camber-increasing hump. ``closed_te=True`` gives the -0.1036 variant
    for consumers that need a watertight loop (e.g. raster masks).
    """
    m = m / 100.0
    p = p / 10.0
    t = t / 100.0
    beta = np.pi * np.arange(n + 1) / n
    x = 0.5 * (1.0 - np.cos(beta))
    yt = 5.0 * t * (
        0.2969 * np.sqrt(x)
        - 0.1260 * x
        - 0.3516 * x**2
        + 0.2843 * x**3
        - (0.1036 if closed_te else 0.1015) * x**4
    )
    yc = np.zeros_like(x)
    dyc = np.zeros_like(x)
    if m > 0:
        front = x < p
        yc = np.where(front, m / p**2 * (2 * p * x - x**2),
                      m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * x - x**2))
        dyc = np.where(front, 2 * m / p**2 * (p - x),
                       2 * m / (1 - p) ** 2 * (p - x))
    theta = np.arctan(dyc)
    xu = x - yt * np.sin(theta)
    yu = yc + yt * np.cos(theta)
    xl = x + yt * np.sin(theta)
    yl = yc - yt * np.cos(theta)
    upper = np.stack([xu, yu], axis=1)[::-1]       # TE -> LE
    lower = np.stack([xl, yl], axis=1)[1:]         # LE (excl) -> TE
    return np.concatenate([upper, lower], axis=0)


_CLARK_Y_PCT = [
    (100, 0.44), (95, 1.46), (90, 2.22), (80, 3.69), (70, 5.07), (60, 6.23),
    (50, 7.10), (40, 7.62), (30, 7.79), (25, 7.67), (20, 7.35), (15, 6.79),
    (10, 5.88), (7.5, 5.23), (5, 4.39), (2.5, 3.18), (1.25, 2.17), (0, 0),
    (1.25, -1.35), (2.5, -1.93), (5, -2.55), (7.5, -2.90), (10, -3.05),
    (15, -3.01), (20, -2.75), (25, -2.41), (30, -2.06), (40, -1.38),
    (50, -0.85), (60, -0.44), (70, -0.16), (80, 0), (90, 0), (95, 0),
    (100, -0.44),
]


def clark_y() -> np.ndarray:
    """Clark-Y coordinate table (percent-chord, reference html:118-121)."""
    return np.array(_CLARK_Y_PCT, dtype=np.float64) / 100.0


SHAPES = {
    "naca0012": lambda: naca4(0, 0, 12, 50),
    "naca2412": lambda: naca4(2, 4, 12, 50),
    "naca4412": lambda: naca4(4, 4, 12, 50),
    "naca6409": lambda: naca4(6, 4, 9, 50),
    "clark_y": clark_y,
}
