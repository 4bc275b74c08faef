"""Airfoil -> lattice solid-mask rasterization (host-side NumPy).

A copy of ``airfoil_tpu/lbm/masks.py``: importing that module loads
``airfoil_tpu.lbm``, whose package imports JAX. The arithmetic is
unchanged and tested for exact equality with the reference. Rotate the
loop about the quarter chord by -alpha, re-panelise to 160 cosine
arc-length points, and scanline-fill the polygon onto the lattice.
"""

from __future__ import annotations

import numpy as np

from airfoil_tpu.config import LBMConfig, DEFAULT_LBM

__all__ = ["rasterize_airfoil", "build_mask"]


def _rotate(coords: np.ndarray, alpha_deg: float) -> np.ndarray:
    a = -np.deg2rad(alpha_deg)
    ca, sa = np.cos(a), np.sin(a)
    px, py = 0.25, 0.0
    dx = coords[:, 0] - px
    dy = coords[:, 1] - py
    return np.stack([px + dx * ca - dy * sa, py + dx * sa + dy * ca], axis=1)


def _panelise(coords: np.ndarray, n: int = 160) -> tuple[np.ndarray, np.ndarray]:
    x, y = coords[:, 0], coords[:, 1]
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
    s = arc[-1] * 0.5 * (1.0 - np.cos(np.pi * np.arange(n + 1) / n))
    return np.interp(s, arc, x), np.interp(s, arc, y)


def rasterize_airfoil(
    coords,
    alpha_deg: float,
    cfg: LBMConfig = DEFAULT_LBM,
) -> np.ndarray:
    """Rasterize the rotated loop to a (NY, NX) float32 solid mask.

    Uses the jax-free native C++ scanline path of ``airfoil_tpu.native``
    when a host compiler is available; pure NumPy otherwise.
    """
    coords = np.asarray(coords, np.float64)
    xp, yp = _panelise(_rotate(coords, alpha_deg))
    nx, ny = cfg.nx, cfg.ny

    from airfoil_tpu.native import raster_mask_native

    native = raster_mask_native(xp, yp, nx, ny,
                                (cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1))
    if native is not None:
        return native
    mask = np.zeros((ny, nx), np.float32)
    n = len(xp)
    for iy in range(ny):
        wy = cfg.dy0 + (iy + 0.5) / ny * (cfg.dy1 - cfg.dy0)
        crossings = []
        for i in range(n - 1):
            y1, y2 = yp[i], yp[i + 1]
            if (y1 > wy) != (y2 > wy):
                crossings.append(xp[i] + (xp[i + 1] - xp[i]) * (wy - y1) / (y2 - y1))
        crossings.sort()
        for k in range(0, len(crossings) - 1, 2):
            ix0 = max(0, int(np.ceil((crossings[k] - cfg.dx0)
                                     / (cfg.dx1 - cfg.dx0) * nx)))
            ix1 = min(nx - 1, int(np.floor((crossings[k + 1] - cfg.dx0)
                                           / (cfg.dx1 - cfg.dx0) * nx)))
            if ix1 >= ix0:
                mask[iy, ix0:ix1 + 1] = 1.0
    return mask


def build_mask(coords, alpha_deg: float, cfg: LBMConfig = DEFAULT_LBM):
    """Mask plus the rotated outline (for overlay rendering)."""
    outline = _rotate(np.asarray(coords, np.float64), alpha_deg)
    return rasterize_airfoil(coords, alpha_deg, cfg), outline
