"""Airfoil -> lattice solid-mask rasterization (host side).

Port of ``airfoil_tpu/lbm/masks.py``: rotate the loop about the quarter
chord by -alpha, re-panelise to 160 cosine arc-length points, and
scanline-fill the polygon onto the lattice. As in the reference, the
native C++ scanline (``airfoil_tpu_torch.native``) fills it where ``g++``
is present; elsewhere ``raster_mask_numpy`` computes every row's
crossings at once with the same float64 operations. Both equal the
reference's mask element for element (``tests/test_torch_isolation.py``,
``tests/test_torch_native.py``); ``rasteriser()`` names the one in use.
"""

from __future__ import annotations

import numpy as np

from airfoil_tpu_torch.config import LBMConfig, DEFAULT_LBM
from airfoil_tpu_torch.native import native_available, raster_mask_native

__all__ = ["rasterize_airfoil", "build_mask", "rasteriser",
           "raster_mask_numpy"]


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


def rasteriser() -> str:
    """The scanline ``rasterize_airfoil`` uses: ``"native"`` where the
    native library builds, else ``"numpy"``."""
    return "native" if native_available() else "numpy"


def rasterize_airfoil(
    coords,
    alpha_deg: float,
    cfg: LBMConfig = DEFAULT_LBM,
) -> np.ndarray:
    """Rasterize the rotated loop to a (NY, NX) float32 solid mask, by the
    native scanline where available, else ``raster_mask_numpy``."""
    coords = np.asarray(coords, np.float64)
    xp, yp = _panelise(_rotate(coords, alpha_deg))
    domain = (cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1)
    mask = raster_mask_native(xp, yp, cfg.nx, cfg.ny, domain)
    if mask is None:
        mask = raster_mask_numpy(xp, yp, cfg.nx, cfg.ny, domain)
    return mask


def raster_mask_numpy(xp, yp, nx: int, ny: int, domain) -> np.ndarray:
    """The scanline of ``native.raster_mask_native`` in numpy: on each
    row's centre line, the cells between the 1st and 2nd, 3rd and 4th, ...
    crossings of the polygon's edges, in x order, are solid."""
    xp, yp = np.asarray(xp, np.float64), np.asarray(yp, np.float64)
    dx0, dx1, dy0, dy1 = domain
    wy = (dy0 + (np.arange(ny) + 0.5) / ny * (dy1 - dy0))[:, None]
    x1, x2, y1, y2 = xp[:-1], xp[1:], yp[:-1], yp[1:]
    hit = (y1 > wy) != (y2 > wy)                          # (ny, n - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cross = x1 + (x2 - x1) * (wy - y1) / (y2 - y1)
    cross = np.sort(np.where(hit, cross, np.inf), axis=1)
    count = hit.sum(axis=1)
    # Pair k spans crossings 2k and 2k + 1 where both exist.
    lo, hi = cross[:, 0:-1:2], cross[:, 1::2]
    pair = 2 * np.arange(lo.shape[1]) + 1 < count[:, None]
    scale = dx1 - dx0
    ix0 = np.ceil((np.where(pair, lo, 0.0) - dx0) / scale * nx)
    ix1 = np.floor((np.where(pair, hi, 0.0) - dx0) / scale * nx)
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
