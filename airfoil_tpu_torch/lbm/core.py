"""D2Q9 lattice-Boltzmann core as torch ops: the plain version of the kernel.

Port of ``airfoil_tpu/lbm/core.py``. ``f`` is a (9, NY, NX) float32
tensor; ``torch.roll`` is the periodic gather, exactly as ``jnp.roll`` is
in the reference. One step:

- gather-form streaming (each cell pulls f_i from x - e_i, periodic),
- half-way bounce-back where the source cell or the cell itself is solid,
- zero-gradient outflow in the last column (copy of the left neighbour's
  pre-stream state; the outlet wins at the right-hand corners),
- BGK collision with the stability clamps rho in [0.5, 2], |u| <= 0.35,
- equilibrium inlet/top/bottom at (rho=1, u=(U0, 0)) on fluid edge cells.

Scalar constants are formed in float32 (as JAX forms them from its traced
float32 scalars), so the per-cell arithmetic matches the reference's.
``lbm_step`` is what the CUDA kernel in ``lbm/kernel.py`` is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from airfoil_tpu_torch.device import DTYPE

__all__ = [
    "D2Q9_E", "D2Q9_W", "D2Q9_OPP",
    "equilibrium", "equilibrium_init", "macro_fields",
    "boundary_masks", "bounce_masks", "cell_word", "edge_equilibrium",
    "inverse_tau",
    "step_body", "lbm_step",
]

# Direction set (ex, ey): 0 rest; 1..4 axis; 5..8 diagonals.
D2Q9_E = np.array(
    [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
     (1, 1), (-1, 1), (-1, -1), (1, -1)], dtype=np.int32)
D2Q9_W = np.array(
    [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=np.float32)
D2Q9_OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)


def equilibrium(rho, ux, uy):
    """BGK equilibrium for all 9 directions; returns (9, ...) stacked."""
    uu = ux * ux + uy * uy
    fs = []
    for i in range(9):
        ex, ey = float(D2Q9_E[i, 0]), float(D2Q9_E[i, 1])
        eu = ex * ux + ey * uy
        fs.append(float(D2Q9_W[i]) * rho
                  * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu))
    return torch.stack(fs)


def equilibrium_init(ny: int, nx: int, u0: float, device) -> torch.Tensor:
    """Uniform-freestream initial distributions on ``device``."""
    rho = torch.ones((ny, nx), dtype=DTYPE, device=device)
    ux = torch.full((ny, nx), float(np.float32(u0)), dtype=DTYPE,
                    device=device)
    uy = torch.zeros((ny, nx), dtype=DTYPE, device=device)
    return equilibrium(rho, ux, uy)


def macro_fields(f):
    """(rho, ux, uy) from a (9, NY, NX) distribution stack."""
    rho = torch.sum(f, dim=0)
    inv = 1.0 / rho
    ux = (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) * inv
    uy = (f[2] + f[5] + f[6] - f[4] - f[7] - f[8]) * inv
    return rho, ux, uy


def _roll2(a, dy: int, dx: int):
    if dy or dx:
        a = torch.roll(a, shifts=(dy, dx), dims=(0, 1))
    return a


def boundary_masks(ny: int, nx: int, device):
    """(is_outlet, is_edge_eq) boolean (NY, NX) masks. Outlet wins at the
    right-edge corners."""
    col = torch.arange(nx, device=device).expand(ny, nx)
    row = torch.arange(ny, device=device).unsqueeze(1).expand(ny, nx)
    is_outlet = col == nx - 1
    is_edge_eq = ((col == 0) | (row == 0) | (row == ny - 1)) & ~is_outlet
    return is_outlet, is_edge_eq


def bounce_masks(solid):
    """Per-direction bounce-back masks, time-invariant: ``bounce[i]`` is
    True where the streaming source of direction i, or the cell itself, is
    solid."""
    is_solid = solid > 0.5
    out = []
    for i in range(9):
        ex, ey = int(D2Q9_E[i, 0]), int(D2Q9_E[i, 1])
        if ex == 0 and ey == 0:
            out.append(is_solid)
        else:
            out.append((_roll2(solid, ey, ex) > 0.5) | is_solid)
    return tuple(out)


OUTLET_BIT = 9
EDGE_BIT = 10


def cell_word(solid):
    """The static cell word of a (NY, NX) mask as (NY, NX) uint16: bit i
    (0-8) is ``bounce_masks(solid)[i]``, bit 9 the outlet and bit 10 the
    edge equilibrium of ``boundary_masks``. It is what the CUDA kernels
    read per cell; ``lbm/kernel.py::cell_word`` builds it on the card."""
    bits = torch.zeros(solid.shape, dtype=torch.int32, device=solid.device)
    for i, bounce in enumerate(bounce_masks(solid)):
        bits |= bounce.to(torch.int32) << i
    is_outlet, is_edge_eq = boundary_masks(solid.shape[0], solid.shape[1],
                                           solid.device)
    bits |= is_outlet.to(torch.int32) << OUTLET_BIT
    bits |= is_edge_eq.to(torch.int32) << EDGE_BIT
    return bits.to(torch.uint16)


def edge_equilibrium(u0: float) -> list[float]:
    """The 9 equilibrium populations at (rho=1, u=(U0, 0)) that the inlet,
    top and bottom edges are set to, computed in float32."""
    one, u0f = np.float32(1.0), np.float32(u0)
    out = []
    for i in range(9):
        eu0 = np.float32(D2Q9_E[i, 0]) * u0f
        feq = D2Q9_W[i] * (one + np.float32(3.0) * eu0
                           + np.float32(4.5) * eu0 * eu0
                           - np.float32(1.5) * u0f * u0f)
        out.append(float(np.float32(feq)))
    return out


def inverse_tau(tau: float) -> float:
    """1/tau in float32."""
    return float(np.float32(1.0) / np.float32(tau))


def step_body(f, solid, u0, tau, masks=None, bounce=None,
              u_max=0.35, rho_min=0.5, rho_max=2.0):
    """One fused stream+BC+collide step. ``f``: (9, NY, NX); ``solid``:
    (NY, NX) float {0,1}. ``masks`` / ``bounce``: optional precomputed
    ``boundary_masks`` / ``bounce_masks`` (callers running many steps
    hoist them). Returns the next (9, NY, NX)."""
    ny, nx = f.shape[1], f.shape[2]
    is_outlet, is_edge_eq = (masks if masks is not None
                             else boundary_masks(ny, nx, f.device))
    is_solid = solid > 0.5
    if bounce is None:
        bounce = bounce_masks(solid)

    fin = []
    for i in range(9):
        ex, ey = int(D2Q9_E[i, 0]), int(D2Q9_E[i, 1])
        v = torch.where(bounce[i], f[D2Q9_OPP[i]], _roll2(f[i], ey, ex))
        v = torch.where(is_outlet, _roll2(f[i], 0, 1), v)
        fin.append(v)

    rho = fin[0]
    for i in range(1, 9):
        rho = rho + fin[i]
    inv = 1.0 / rho
    ux = (fin[1] + fin[5] + fin[8] - fin[3] - fin[6] - fin[7]) * inv
    uy = (fin[2] + fin[5] + fin[6] - fin[4] - fin[7] - fin[8]) * inv

    rho_c = torch.clamp(rho, rho_min, rho_max)
    spd = torch.sqrt(ux * ux + uy * uy)
    scale = torch.where(spd > u_max, u_max / torch.clamp(spd, min=1e-12), 1.0)
    ux_c = ux * scale
    uy_c = uy * scale

    uu = ux_c * ux_c + uy_c * uy_c
    inv_tau = inverse_tau(tau)
    feq_in = edge_equilibrium(u0)
    skip_collide = is_solid | is_outlet
    apply_edge = is_edge_eq & ~is_solid

    out = []
    for i in range(9):
        ex, ey = float(D2Q9_E[i, 0]), float(D2Q9_E[i, 1])
        w = float(D2Q9_W[i])
        eu = ex * ux_c + ey * uy_c
        feq = w * rho_c * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu)
        fo = fin[i] - (fin[i] - feq) * inv_tau
        v = torch.where(skip_collide, fin[i], fo)
        v = torch.where(apply_edge, feq_in[i], v)
        out.append(v)
    return torch.stack(out)


def lbm_step(f, solid, u0, tau, steps: int = 1):
    """Advance ``steps`` fused stream-collide steps with torch ops."""
    masks = boundary_masks(f.shape[1], f.shape[2], f.device)
    bounce = bounce_masks(solid)
    for _ in range(steps):
        f = step_body(f, solid, u0, tau, masks=masks, bounce=bounce)
    return f
