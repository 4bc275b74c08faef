"""Lattice diagnostics as torch ops: forces, separation fraction, fields.

Port of ``airfoil_tpu/lbm/diagnostics.py``. Forces sum the lattice
pressure p = rho/3 over solid-cell faces adjacent to fluid, made
dimensionless by 0.5 U0^2 chord_cells; the separation fraction is the
share of those faces whose fluid neighbour has reversed streamwise flow
(a count of sign tests, so it flips cell by cell where ux ~ 0 at the wall).
Both stay on the tensor's device; the caller reads three scalars.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from airfoil_tpu_torch.lbm.core import macro_fields

__all__ = ["forces_and_separation", "render_fields"]

_FACES = ((0, 1), (1, 0), (0, -1), (-1, 0))  # (dy, dx)


def forces_and_separation(f, solid, u0: float, chord_cells: float):
    """Returns 0-dim tensors (cl, cd, sep_fraction) for the current state."""
    rho, ux, _uy = macro_fields(f)
    p = rho / 3.0
    is_solid = solid > 0.5

    fx = fy = surf = rev = 0.0
    for dy, dx in _FACES:
        # Neighbour cell at (y+dy, x+dx) as seen from each solid cell.
        nb_solid = torch.roll(is_solid, (-dy, -dx), dims=(0, 1))
        nb_p = torch.roll(p, (-dy, -dx), dims=(0, 1))
        nb_ux = torch.roll(ux, (-dy, -dx), dims=(0, 1))
        face = is_solid & ~nb_solid
        # Force on the body points from the fluid into the solid: -d.
        face_p = torch.sum(torch.where(face, nb_p, 0.0))
        fx = fx + face_p * (-dx)
        fy = fy + face_p * (-dy)
        surf = surf + torch.sum(face)
        rev = rev + torch.sum(face & (nb_ux < 0.0))

    u0f = np.float32(u0)
    q = float(np.float32(0.5) * u0f * u0f * np.float32(chord_cells))
    cl = fy / q
    cd = fx / q
    sep = rev / torch.clamp(surf, min=1).to(p.dtype)
    return cl, cd, sep


def render_fields(f, solid, u0: float):
    """(speed, cp, vorticity, ux, uy) fields for visualisation: speed
    |u|/U0, Cp = (rho-1)/(1.5 U0^2), central-difference vorticity. Solid
    cells are NaN for the client colormap."""
    rho, ux, uy = macro_fields(f)
    is_solid = solid > 0.5
    u0f = np.float32(u0)
    speed = torch.sqrt(ux * ux + uy * uy) / float(u0f)
    cp = (rho - 1.0) / float(np.float32(1.5) * u0f * u0f)
    dvydx = 0.5 * (torch.roll(uy, -1, dims=1) - torch.roll(uy, 1, dims=1))
    duxdy = 0.5 * (torch.roll(ux, -1, dims=0) - torch.roll(ux, 1, dims=0))
    vort = dvydx - duxdy
    nanmask = torch.where(is_solid, math.nan, 1.0)
    return (speed * nanmask, cp * nanmask, vort * nanmask, ux * nanmask,
            uy * nanmask)
