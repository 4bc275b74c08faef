"""NACA 4-digit section generator: a copy of ``naca4`` from
``airfoil_tpu/models/naca.py`` (NumPy), kept so that the port imports
nothing of the JAX package. Returns a Selig-ordered loop (TE -> upper ->
LE -> lower -> TE).
"""

from __future__ import annotations

import numpy as np

__all__ = ["naca4"]


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
