"""Paneling stage: port of ``airfoil_tpu/paneling/panel.py``.

Resamples a parsed coordinate loop onto ``n_panels + 1`` arc-length
stations and computes midpoints, tangents, inward normals and lengths, on
the tensors' device in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.numerics import interp

__all__ = [
    "Paneling",
    "repanel",
    "panel_geometry",
    "rotate_about_quarter_chord",
]


class Paneling(NamedTuple):
    """Panel discretisation of an airfoil loop (Selig order, TE->...->TE).

    ``xp, yp``: (N+1,) node coordinates. ``xm, ym``: (N,) collocation points
    (panel midpoints). ``tx, ty``: unit tangents along traversal direction.
    ``nx, ny``: unit *inward* normals. ``length``: panel lengths. ``s``:
    (N+1,) node arc-length stations.
    """

    xp: torch.Tensor
    yp: torch.Tensor
    xm: torch.Tensor
    ym: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    length: torch.Tensor
    s: torch.Tensor


def _as_tensor(a, device=None) -> torch.Tensor:
    """``a`` as a float32 tensor: a tensor stays on its device, anything
    else goes to ``resolve_device(device)``."""
    if isinstance(a, torch.Tensor):
        return a.to(DTYPE)
    return torch.as_tensor(np.asarray(a, dtype=np.float32),
                           device=resolve_device(device))


def _arc_length(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    seg = torch.hypot(torch.diff(x), torch.diff(y))
    return torch.cat([x.new_zeros(1), torch.cumsum(seg, 0)])


def repanel(
    coords,
    n_panels: int = 160,
    spacing: str = "airfoil",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resample a (M, 2) loop onto ``n_panels + 1`` arc-length stations.

    ``spacing='airfoil'`` (default) clusters nodes at the trailing edge and
    at the leading edge (the arc position of minimum x) with a per-side
    cosine law; ``'cosine'`` is one cosine over the whole arc;
    ``'uniform'`` is uniform in arc length. ``coords`` may be a tensor (its
    device is kept) or an array (placed on ``device``, see
    ``resolve_device``).
    """
    coords = _as_tensor(coords, device)
    x, y = coords[:, 0], coords[:, 1]
    arc = _arc_length(x, y)
    total = arc[-1]
    kw = dict(dtype=DTYPE, device=coords.device)
    if spacing == "cosine":
        beta = torch.linspace(0.0, math.pi, n_panels + 1, **kw)
        s_new = total * 0.5 * (1.0 - torch.cos(beta))
    elif spacing == "uniform":
        s_new = torch.linspace(0.0, 1.0, n_panels + 1, **kw) * total
    elif spacing == "airfoil":
        if n_panels % 2:
            raise ValueError("'airfoil' spacing requires an even n_panels")
        half = n_panels // 2
        s_le = arc[torch.argmin(x)]
        beta = torch.linspace(0.0, math.pi, half + 1, **kw)
        ramp = 0.5 * (1.0 - torch.cos(beta))
        s_up = s_le * ramp
        s_lo = s_le + (total - s_le) * ramp
        s_new = torch.cat([s_up, s_lo[1:]])
    else:
        raise ValueError(f"unknown spacing {spacing!r}")
    return interp(s_new, arc, x), interp(s_new, arc, y)


def panel_geometry(xp: torch.Tensor, yp: torch.Tensor) -> Paneling:
    """Compute midpoints, tangents, inward normals, and lengths."""
    dx = torch.diff(xp)
    dy = torch.diff(yp)
    length = torch.hypot(dx, dy) + 1e-14
    tx = dx / length
    ty = dy / length
    # Inward normal: with Selig (counterclockwise) traversal the interior is
    # to the left of the tangent, i.e. (-ty, tx).
    nx = -ty
    ny = tx
    xm = 0.5 * (xp[:-1] + xp[1:])
    ym = 0.5 * (yp[:-1] + yp[1:])
    s = _arc_length(xp, yp)
    return Paneling(xp, yp, xm, ym, tx, ty, nx, ny, length, s)


def rotate_about_quarter_chord(coords: torch.Tensor, alpha_deg
                               ) -> torch.Tensor:
    """Rotate a loop by -alpha about (0.25, 0): positive angle of attack
    pitches the nose up while the freestream stays axis-aligned."""
    a = -torch.deg2rad(torch.as_tensor(alpha_deg, dtype=DTYPE,
                                       device=coords.device))
    ca, sa = torch.cos(a), torch.sin(a)
    px, py = 0.25, 0.0
    dx = coords[..., 0] - px
    dy = coords[..., 1] - py
    return torch.stack([px + dx * ca - dy * sa, py + dx * sa + dy * ca],
                       dim=-1)
