"""Geometry smoothing (``GDES SMOO``'s role): port of
``airfoil_tpu/paneling/smooth.py``.

A shrinkage-free Taubin (lambda | mu) Laplacian filter on the repaneled
loop with the trailing-edge endpoints pinned.
"""

from __future__ import annotations

import torch

__all__ = ["smooth_geometry"]


def smooth_geometry(
    xp: torch.Tensor,
    yp: torch.Tensor,
    passes: int = 10,
    lam: float = 0.5,
    mu: float = -0.52,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Taubin-smooth an open node chain (TE ... TE), endpoints fixed: each
    pass is an inflation step (``lam``) then a deflation step (``mu``) of
    the umbrella Laplacian."""
    pts = torch.stack([xp, yp], dim=1)

    def _step(p: torch.Tensor, weight: float) -> torch.Tensor:
        lap = 0.5 * (p[:-2] + p[2:]) - p[1:-1]
        interior = p[1:-1] + weight * lap
        return torch.cat([p[:1], interior, p[-1:]], dim=0)

    for _ in range(passes):
        pts = _step(_step(pts, lam), mu)
    return pts[:, 0], pts[:, 1]
