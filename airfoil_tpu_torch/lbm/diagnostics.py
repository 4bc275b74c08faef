"""Lattice diagnostics as torch ops: forces, separation fraction, fields.

Port of ``airfoil_tpu/lbm/diagnostics.py``. Forces sum the lattice
pressure p = rho/3 over solid-cell faces adjacent to fluid, made
dimensionless by 0.5 U0^2 chord_cells; the separation fraction is the
share of those faces whose fluid neighbour has reversed streamwise flow
(a count of sign tests, so it flips cell by cell where ux ~ 0 at the wall).
Both stay on the tensor's device; the caller reads three scalars.

``frame_fields`` is both, the forces and then the fields, as the program
``"frame"`` of the compiled-program layer (``viscous.graphs``): one CUDA
graph a (grid, ``chord_cells``) key on the card, with ``u0`` a tensor
input, since a tunnel's ``set_u0`` changes it; on the CPU the same body
eagerly. Its numbers equal the two functions' bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from airfoil_tpu_torch.lbm.core import macro_fields
from airfoil_tpu_torch.viscous import graphs

__all__ = ["forces_and_separation", "frame_fields", "render_fields"]

_FACES = ((0, 1), (1, 0), (0, -1), (-1, 0))  # (dy, dx)


def _face_sums(rho, ux, is_solid):
    """(fx, fy, sep_fraction): the pressure force on the solid's faces and
    the share of them with reversed flow beside them."""
    p = rho / 3.0
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
    return fx, fy, rev / torch.clamp(surf, min=1).to(p.dtype)


def _vorticity(ux, uy):
    dvydx = 0.5 * (torch.roll(uy, -1, dims=1) - torch.roll(uy, 1, dims=1))
    duxdy = 0.5 * (torch.roll(ux, -1, dims=0) - torch.roll(ux, 1, dims=0))
    return dvydx - duxdy


def forces_and_separation(f, solid, u0: float, chord_cells: float):
    """Returns 0-dim tensors (cl, cd, sep_fraction) for the current state."""
    rho, ux, _uy = macro_fields(f)
    fx, fy, sep = _face_sums(rho, ux, solid > 0.5)
    u0f = np.float32(u0)
    q = float(np.float32(0.5) * u0f * u0f * np.float32(chord_cells))
    return fy / q, fx / q, sep


def render_fields(f, solid, u0: float):
    """(speed, cp, vorticity, ux, uy) fields for visualisation: speed
    |u|/U0, Cp = (rho-1)/(1.5 U0^2), central-difference vorticity. Solid
    cells are NaN for the client colormap."""
    rho, ux, uy = macro_fields(f)
    u0f = np.float32(u0)
    speed = torch.sqrt(ux * ux + uy * uy) / float(u0f)
    cp = (rho - 1.0) / float(np.float32(1.5) * u0f * u0f)
    nanmask = torch.where(solid > 0.5, math.nan, 1.0)
    return (speed * nanmask, cp * nanmask, _vorticity(ux, uy) * nanmask,
            ux * nanmask, uy * nanmask)


def _over(x, d):
    """``x / float(d)`` for a 0-dim float32 tensor ``d``, rounded as torch
    rounds a division by a host number: on CUDA a product with the
    number's float32 reciprocal, on the CPU a division."""
    return x * torch.reciprocal(d) if x.is_cuda else x / d


def _frame_body(chord_cells: float, flat):
    """``forces_and_separation`` then ``render_fields`` of (f, solid, u0),
    ``u0`` a 0-dim tensor: (cl, cd, sep, speed, cp, vorticity, ux, uy).
    The numbers of ``u0`` are formed on the device in the functions' order
    (``0.5 u0 u0 chord_cells``, ``1.5 u0 u0``), so their bits are the
    functions'."""
    f, solid, u0 = flat
    rho, ux, uy = macro_fields(f)
    is_solid = solid > 0.5
    fx, fy, sep = _face_sums(rho, ux, is_solid)
    q = 0.5 * u0 * u0 * chord_cells
    speed = _over(torch.sqrt(ux * ux + uy * uy), u0)
    cp = _over(rho - 1.0, 1.5 * u0 * u0)
    nanmask = torch.where(is_solid, math.nan, 1.0)
    return (_over(fy, q), _over(fx, q), sep, speed * nanmask, cp * nanmask,
            _vorticity(ux, uy) * nanmask, ux * nanmask, uy * nanmask)


def frame_fields(f, solid, u0: float, chord_cells: float):
    """(cl, cd, sep_fraction, speed, cp, vorticity, ux, uy) of the current
    state: ``forces_and_separation`` and ``render_fields`` as the program
    ``"frame"``, keyed by the device, the grid and ``chord_cells``."""
    u0_t = graphs.as_input(float(np.float32(u0)), f)
    key = (f.device, tuple(f.shape[1:]), chord_cells)
    return graphs.run("frame", key,
                      functools.partial(_frame_body, chord_cells),
                      [f, solid, u0_t])
