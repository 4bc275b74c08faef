"""Airfoil -> lattice solid-mask rasterization (host-side NumPy).

Port of ``airfoil_tpu/lbm/masks.py``: rotate the loop about the quarter
chord by -alpha, re-panelise to 160 cosine arc-length points, and
scanline-fill the polygon onto the lattice. The reference fills row by row
in Python or through its native C++ library; here every row's crossings
are computed at once with the same float64 operations, so the mask equals
the reference's element for element (``tests/test_torch_isolation.py``).
"""

from __future__ import annotations

import numpy as np

from airfoil_tpu_torch.config import LBMConfig, DEFAULT_LBM

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
    """Rasterize the rotated loop to a (NY, NX) float32 solid mask: on each
    row's centre line, the cells between the 1st and 2nd, 3rd and 4th, ...
    crossings of the polygon's edges, in x order, are solid."""
    coords = np.asarray(coords, np.float64)
    xp, yp = _panelise(_rotate(coords, alpha_deg))
    nx, ny = cfg.nx, cfg.ny
    wy = (cfg.dy0 + (np.arange(ny) + 0.5) / ny * (cfg.dy1 - cfg.dy0))[:, None]
    x1, x2, y1, y2 = xp[:-1], xp[1:], yp[:-1], yp[1:]
    hit = (y1 > wy) != (y2 > wy)                          # (ny, n - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cross = x1 + (x2 - x1) * (wy - y1) / (y2 - y1)
    cross = np.sort(np.where(hit, cross, np.inf), axis=1)
    count = hit.sum(axis=1)
    # Pair k spans crossings 2k and 2k + 1 where both exist.
    lo, hi = cross[:, 0:-1:2], cross[:, 1::2]
    pair = 2 * np.arange(lo.shape[1]) + 1 < count[:, None]
    scale = cfg.dx1 - cfg.dx0
    ix0 = np.ceil((np.where(pair, lo, 0.0) - cfg.dx0) / scale * nx)
    ix1 = np.floor((np.where(pair, hi, 0.0) - cfg.dx0) / scale * nx)
    ix0 = np.maximum(ix0, 0).astype(np.int64)
    ix1 = np.minimum(ix1, nx - 1).astype(np.int64)
    rows, ks = np.nonzero(pair & (ix1 >= ix0))
    mask = np.zeros((ny, nx), np.float32)
    for iy, a, b in zip(rows, ix0[rows, ks], ix1[rows, ks]):
        mask[iy, a:b + 1] = 1.0
    return mask


def build_mask(coords, alpha_deg: float, cfg: LBMConfig = DEFAULT_LBM):
    """Mask plus the rotated outline (for overlay rendering)."""
    outline = _rotate(np.asarray(coords, np.float64), alpha_deg)
    return rasterize_airfoil(coords, alpha_deg, cfg), outline
