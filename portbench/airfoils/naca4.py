"""Maker of NACA 4-digit section files: ``make(spec, rng)`` gives (file
name, Selig bytes) of a section whose digits are drawn from ``spec``'s
ranges, bounds included: ``camber_pct`` (maximum camber, % of the chord),
``camber_pos`` (its position, in tenths), ``thickness_pct``; with
``points_per_side`` cosine-spaced points a side. A range of one value
fixes a digit."""

from __future__ import annotations

import numpy as np


def naca4(m: float, p: float, t: float, n: int) -> np.ndarray:
    """A NACA 4-digit section (open trailing edge) in Selig order: ``n``
    cosine-spaced points from the trailing edge over the upper side to the
    nose, then ``n - 1`` back along the lower side."""
    x = 0.5 * (1.0 - np.cos(np.linspace(0.0, np.pi, n)))
    yt = 5.0 * t * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
                    + 0.2843 * x ** 3 - 0.1015 * x ** 4)
    if m > 0:
        fore = x < p
        yc = np.where(fore, m / p ** 2 * (2 * p * x - x ** 2),
                      m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * x - x ** 2))
        dyc = np.where(fore, 2 * m / p ** 2 * (p - x),
                       2 * m / (1 - p) ** 2 * (p - x))
    else:
        yc = dyc = np.zeros_like(x)
    th = np.arctan(dyc)
    upper = np.stack([x - yt * np.sin(th), yc + yt * np.cos(th)], axis=1)
    lower = np.stack([x + yt * np.sin(th), yc - yt * np.cos(th)], axis=1)
    return np.concatenate([upper[::-1], lower[1:]])


def selig_text(name: str, coords: np.ndarray) -> bytes:
    lines = [name] + [f"{x:.8f} {y:.8f}" for x, y in coords]
    return ("\n".join(lines) + "\n").encode()


def make(spec: dict, rng: np.random.Generator) -> tuple[str, bytes]:
    def digit(key):
        lo, hi = spec[key]
        return int(rng.integers(lo, hi + 1))

    m, p, t = digit("camber_pct"), digit("camber_pos"), digit("thickness_pct")
    name = f"NACA {m}{p if m else 0}{t:02d}"
    coords = naca4(m / 100, p / 10, t / 100, spec["points_per_side"])
    return name.replace(" ", "") + ".dat", selig_text(name, coords)
