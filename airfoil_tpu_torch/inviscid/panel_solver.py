"""Linear-strength vortex panel solver with source transpiration: port of
``airfoil_tpu/inviscid/panel_solver.py``.

Nodal vortex strengths (N+1 unknowns for N panels), flow tangency at the
panel midpoints and the Kutta condition ``gamma[0] + gamma[N] = 0``;
constant-strength source panels enter the right-hand side only, so the
influence operator is LU-factored once per geometry and every
(alpha, sigma) evaluation is a pair of triangular solves with two passes
of iterative refinement. The kernels, the trailing-edge gap panel and the
sharp-TE row blend are the reference's, line for line; see that module's
comments for their derivation.

Dense float32 algebra throughout (``torch.linalg.lu_factor_ex``/
``lu_solve``, full-float32 matvecs with TF32 off, see ``device``).

Leading axes of a paneling are lanes, one geometry each (the reference's
``vmap`` over geometries): ``build_operator`` then builds B operators at
once (B influence fills, one batched LU), and ``solve_inviscid`` solves
each at one alpha. A lane's operator and solution equal the one-geometry
ones bit for bit on the CPU: matrix-vector products, which a CPU BLAS
rounds differently when batched, go lane by lane (``lane_mm``); a
degenerate lane gives NaNs and neither raises nor touches the others.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch

from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.numerics import clip
from airfoil_tpu_torch.paneling import Paneling

__all__ = [
    "InviscidOperator",
    "InviscidSolution",
    "build_operator",
    "factor",
    "influence",
    "lane_mm",
    "operator_from_numpy",
    "sensitivities",
    "solve_inviscid",
    "velocity_at_points",
]

_TWO_PI = 2.0 * math.pi


def _local_frame(px, py, pan: Paneling):
    """Panel-local coordinates of points (P,) w.r.t. all panels (N,).

    Returns (xi, eta, length) each of shape (P, N) (with lanes (B, P, N)).
    """
    dxp = px[..., :, None] - pan.xp[..., None, :-1]
    dyp = py[..., :, None] - pan.yp[..., None, :-1]
    c = pan.tx[..., None, :]
    s = pan.ty[..., None, :]
    xi = dxp * c + dyp * s
    eta = -dxp * s + dyp * c
    return xi, eta, pan.length[..., None, :]


def _kernels(xi, eta, l, self_mask=None):
    """Vortex (constant + ramp) and source kernels in panel-local coords.

    Returns ``(u_c, v_c, u_r, v_r, u_s, v_s)``, each (P, N), per unit
    strength. Where ``self_mask`` marks the panel's own midpoint the
    exterior-side limit (angle jump +pi, log term 0) is substituted. The
    angle and log differences are the reference's cancellation-free forms.
    """
    r2sq = (xi - l) ** 2 + eta * eta + 1e-20
    delta = -torch.atan2(eta * l, xi * (xi - l) + eta * eta)
    logr = 0.5 * torch.log1p(l * (2.0 * xi - l) / r2sq)
    if self_mask is not None:
        delta = torch.where(self_mask, math.pi, delta)
        logr = torch.where(self_mask, 0.0, logr)
    u_c = delta / _TWO_PI
    v_c = logr / _TWO_PI
    u_r = (xi * delta + eta * logr) / (_TWO_PI * l)
    v_r = (xi * logr - eta * delta - l) / (_TWO_PI * l)
    u_s = logr / _TWO_PI
    v_s = -delta / _TWO_PI
    return u_c, v_c, u_r, v_r, u_s, v_s


def _to_global(u, v, pan: Paneling):
    c = pan.tx[..., None, :]
    s = pan.ty[..., None, :]
    return u * c - v * s, u * s + v * c


def _te_maps(px, py, pan: Paneling):
    """TE gap-panel velocity influence per unit (gamma[0] - gamma[N]).

    XFOIL's gap panel: uniform source ``-0.5 (g0 - gN) |s x t|`` and vortex
    ``-0.5 (g0 - gN) |s . t|`` across the gap (``s`` lower -> upper TE
    node, ``t`` the downstream TE bisector). Returns global-frame (u, v),
    each (P,); for a closed TE the maps go smoothly to zero.
    """
    x_u, y_u = pan.xp[..., :1], pan.yp[..., :1]
    x_l, y_l = pan.xp[..., -1:], pan.yp[..., -1:]
    dx, dy = x_u - x_l, y_u - y_l
    gap = torch.hypot(dx, dy)
    inv = 1.0 / clip(gap, 1e-12)
    sx, sy = dx * inv, dy * inv
    # Downstream TE bisector: panel 0 runs TE->LE on the upper surface
    # (reverse it), panel N-1 runs LE->TE on the lower surface.
    bx = 0.5 * (-pan.tx[..., :1] + pan.tx[..., -1:])
    by = 0.5 * (-pan.ty[..., :1] + pan.ty[..., -1:])
    bn = clip(torch.hypot(bx, by), 1e-12)
    bx, by = bx / bn, by / bn
    scs = torch.abs(sx * by - sy * bx)
    sds = torch.abs(sx * bx + sy * by)

    # Panel-local frame along s, origin at the lower TE node.
    dxp = px - x_l
    dyp = py - y_l
    xi = dxp * sx + dyp * sy
    eta = -dxp * sy + dyp * sx
    l = gap
    r2sq = (xi - l) ** 2 + eta * eta + 1e-20
    delta = -torch.atan2(eta * l, xi * (xi - l) + eta * eta)
    logr = 0.5 * torch.log1p(l * (2.0 * xi - l) / r2sq)
    u_c = delta / _TWO_PI
    v_c = logr / _TWO_PI
    u_s = logr / _TWO_PI
    v_s = -delta / _TWO_PI

    sig = -0.5 * scs
    gam = -0.5 * sds
    u_loc = gam * u_c + sig * u_s
    v_loc = gam * v_c + sig * v_s
    return u_loc * sx - v_loc * sy, u_loc * sy + v_loc * sx


class InviscidOperator(NamedTuple):
    """Geometry-dependent factorised influence operator (fields as in the
    reference). ``lu, piv`` are ``torch.linalg.lu_factor``'s factors of
    ``a_full`` (LAPACK's 1-based pivots, not JAX's)."""

    pan: Paneling
    a_full: torch.Tensor
    lu: torch.Tensor
    piv: torch.Tensor
    bn: torch.Tensor
    at_a: torch.Tensor
    at_b: torch.Tensor
    bt: torch.Tensor
    due_dsigma: torch.Tensor
    dgamma_dsigma: torch.Tensor
    at_full: torch.Tensor
    rhs_scale: torch.Tensor


class InviscidSolution(NamedTuple):
    """Result of one inviscid evaluation at a single alpha."""

    gamma: torch.Tensor        # (N+1,) nodal vortex strengths
    vt: torch.Tensor           # (N,) surface tangential velocity / U_inf
    cp: torch.Tensor           # (N,) surface pressure coefficient
    cl: torch.Tensor           # lift coefficient (Cp integration)
    cm: torch.Tensor           # quarter-chord moment coefficient
    cd_pressure: torch.Tensor  # pressure-drag residual (~0; discretisation)
    circulation: torch.Tensor  # total bound circulation


def _gamma_columns(an_a, an_b):
    """Per-node (P, N+1) columns from per-panel (start, end) (P, N) maps."""
    a = an_a.new_zeros((*an_a.shape[:-1], an_a.shape[-1] + 1))
    a[..., :-1] += an_a
    a[..., 1:] += an_b
    return a


def lane_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (matrix-matrix or matrix-vector); with a lane axis (``a``
    (B, m, n), ``b`` (B, n, k) or (B, n)) one product a lane, by a host
    loop: a CPU BLAS rounds a batched matrix-vector product (and a batched
    one-column product) differently from the one-geometry product, so a
    lane would not equal its one-geometry solve."""
    if a.dim() == 2:
        return a @ b
    return torch.stack([ai @ bi for ai, bi in zip(a, b)])


def _refined_solve(a_full, lu, piv, rhs, steps: int = 2):
    """LU solve with ``steps`` passes of iterative refinement (full-float32
    residual matvecs): recovers the digits an f32 factorisation loses on
    the ~1e4-conditioned sharp-TE systems. ``rhs`` is (N+1,) or
    (N+1, K), with the operator's lane axes in front."""
    vec = rhs.dim() == a_full.dim() - 1
    b = rhs[..., None] if vec else rhs
    x = torch.linalg.lu_solve(lu, piv, b)
    for _ in range(steps):
        r = b - lane_mm(a_full, x)
        x = x + torch.linalg.lu_solve(lu, piv, r)
    return x[..., 0] if vec else x


def build_operator(pan: Paneling) -> InviscidOperator:
    """Build and factorise the influence operator for a paneling (for each
    lane of one): the influence fill, the LU factor, then the source
    sensitivities through the factor."""
    op = influence(pan)
    lu, piv = factor(op.a_full)
    ginf, due = sensitivities(op.a_full, lu, piv, op.bn, op.at_full, op.bt)
    return op._replace(lu=lu, piv=piv, due_dsigma=due, dgamma_dsigma=ginf)


def influence(pan: Paneling) -> InviscidOperator:
    """The operator's influence matrices of a paneling: every field but
    ``lu``, ``piv``, ``due_dsigma`` and ``dgamma_dsigma``, which are None
    (``factor``, then ``sensitivities``, fill them in)."""
    n = pan.xm.shape[-1]
    dev = pan.xm.device
    self_mask = torch.eye(n, dtype=torch.bool, device=dev)
    xi, eta, l = _local_frame(pan.xm, pan.ym, pan)
    u_c, v_c, u_r, v_r, u_s, v_s = _kernels(xi, eta, l, self_mask)

    # Panel j's linear vorticity = gamma_j * (ramp down) + gamma_{j+1} * ramp.
    ua, va = _to_global(u_c - u_r, v_c - v_r, pan)
    ub, vb = _to_global(u_r, v_r, pan)
    us, vs = _to_global(u_s, v_s, pan)

    nx = pan.nx[..., :, None]
    ny = pan.ny[..., :, None]
    tx = pan.tx[..., :, None]
    ty = pan.ty[..., :, None]

    an_a = ua * nx + va * ny
    an_b = ub * nx + vb * ny
    bn = us * nx + vs * ny
    at_a = ua * tx + va * ty
    at_b = ub * tx + vb * ty
    bt = us * tx + vs * ty

    # Transpiration boundary condition (V . n_out) = sigma: the identity
    # joins the source influence in the RHS map.
    bn = bn + torch.eye(n, dtype=bn.dtype, device=dev)

    # TE gap panel: columns 0 and N pick up its influence per unit
    # (gamma[0] - gamma[N]).
    u_te, v_te = _te_maps(pan.xm, pan.ym, pan)
    an_te = u_te * pan.nx + v_te * pan.ny
    at_te = u_te * pan.tx + v_te * pan.ty

    an = _gamma_columns(an_a, an_b)
    an[..., :, 0] += an_te
    an[..., :, n] -= an_te

    # Sharp-TE regularisation: both sliver tangency rows blend toward
    # one-sided gamma curvature extrapolations into the TE, fully below a
    # 1e-4 c gap and not at all above 1e-3 c.
    gap = torch.hypot(pan.xp[..., :1] - pan.xp[..., -1:],
                      pan.yp[..., :1] - pan.yp[..., -1:])
    t = clip((gap - 1e-4) / 9e-4, 0.0, 1.0)
    w_sharp = 1.0 - t * t * (3.0 - 2.0 * t)         # (..., 1)
    # Entries are set by ``fill_`` (a kernel), never by assigning a Python
    # number, which copies it from the host: a graph cannot capture that.
    ex_u = an.new_zeros(n + 1)
    ex_l = an.new_zeros(n + 1)
    for j, c in enumerate((1.0, -2.0, 1.0)):
        ex_u[j].fill_(c)
        ex_l[n - j].fill_(c)
    an[..., 0, :] = an[..., 0, :] * (1.0 - w_sharp) + w_sharp * ex_u
    an[..., n - 1, :] = (an[..., n - 1, :] * (1.0 - w_sharp)
                         + w_sharp * ex_l)
    # The blended rows' RHS terms scale identically: ``bn`` here, the
    # freestream and wake-source rows through ``rhs_scale``.
    rhs_scale = an.new_ones(an.shape[:-1])
    rhs_scale[..., 0] = 1.0 - w_sharp[..., 0]
    rhs_scale[..., n - 1] = 1.0 - w_sharp[..., 0]
    bn = bn * rhs_scale[..., :, None]

    a_full = an.new_zeros((*an.shape[:-2], n + 1, n + 1))
    a_full[..., :n, :] = an
    # Kutta: gamma at the two trailing-edge nodes cancel.
    a_full[..., n, 0].fill_(1.0)
    a_full[..., n, n].fill_(1.0)

    at_full = _gamma_columns(at_a, at_b)              # (N, N+1)
    at_full[..., :, 0] += at_te
    at_full[..., :, n] -= at_te
    return InviscidOperator(pan, a_full, None, None, bn, at_a, at_b, bt,
                            None, None, at_full, rhs_scale)


def factor(a_full: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.lu_factor_ex`` of the influence matrix (of each lane):
    (lu, piv). ``_ex``: a singular (degenerate) lane gives NaNs, no error
    and no host read. A matrix with a NaN entry factors to NaN, as in JAX
    (a batched LU on the card leaves part of such a factor finite, and the
    solves would then run on it)."""
    lu, piv, _info = torch.linalg.lu_factor_ex(a_full)
    lu = torch.where(torch.isnan(a_full).any(-1).any(-1)[..., None, None],
                     torch.nan, lu)
    return lu, piv


def sensitivities(a_full, lu, piv, bn, at_full, bt
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dgamma_dsigma, due_dsigma): the vortex strengths' and the edge
    velocity's sensitivity to transpiration sources, through the factor
    (lu, piv) of ``a_full``:
    ``Vt(sigma) = Vt0 + (At A^-1 (-Bn) + Bt) sigma``."""
    rhs = torch.cat([-bn, bn.new_zeros((*bn.shape[:-2], 1, bn.shape[-1]))],
                    dim=-2)
    ginf = _refined_solve(a_full, lu, piv, rhs)       # (N+1, N)
    return ginf, lane_mm(at_full, ginf) + bt


def operator_from_numpy(fields: Mapping, device=None) -> InviscidOperator:
    """The port's operator from a reference ``InviscidOperator``'s fields
    as numpy arrays: ``fields["pan"]`` maps the ``Paneling`` field names,
    the other keys are the operator's. ``lu`` and ``piv`` are not read:
    ``a_full`` is factored again with ``torch.linalg.lu_factor``."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    pan = Paneling(**{k: t(fields["pan"][k]) for k in Paneling._fields})
    lu, piv, _info = torch.linalg.lu_factor_ex(t(fields["a_full"]))
    rest = {k: t(fields[k]) for k in InviscidOperator._fields
            if k not in ("pan", "lu", "piv")}
    return InviscidOperator(pan=pan, lu=lu, piv=piv, **rest)


def _freestream(alpha_deg, like: torch.Tensor):
    a = torch.deg2rad(torch.as_tensor(alpha_deg, dtype=DTYPE,
                                      device=like.device))
    return torch.cos(a), torch.sin(a)


def solve_inviscid(
    op: InviscidOperator,
    alpha_deg,
    sigma: torch.Tensor | None = None,
) -> InviscidSolution:
    """Solve for the surface vorticity and integrate Cp -> CL/Cm.

    ``sigma`` (optional, (N,)) are known transpiration source strengths
    from the boundary layer; ``None`` is the pure inviscid path.
    ``alpha_deg`` may be a vector of A angles (a 1-D tensor or array): the
    solution's arrays then carry a leading axis of A, one solve per angle
    as ``vmap`` over alpha, by one multi-column LU solve. An operator with
    lanes takes one alpha for all of them and gives one solution a lane.
    """
    pan = op.pan
    ca, sa = _freestream(alpha_deg, pan.xm)
    lanes = op.a_full.dim() > 2
    if ca.dim() and lanes:
        raise ValueError("an operator with lanes takes one alpha")
    uinf, vinf = (ca[:, None], sa[:, None]) if ca.dim() else (ca, sa)

    rhs_n = op.rhs_scale * -(uinf * pan.nx + vinf * pan.ny)
    if sigma is not None:
        rhs_n = rhs_n - lane_mm(op.bn, sigma)
    rhs = torch.cat([rhs_n, rhs_n.new_zeros((*rhs_n.shape[:-1], 1))], -1)

    if rhs.dim() > 1 and not lanes:
        gamma = _refined_solve(op.a_full, op.lu, op.piv, rhs.T).T
        vt = uinf * pan.tx + vinf * pan.ty + gamma @ op.at_full.T
    else:
        gamma = _refined_solve(op.a_full, op.lu, op.piv, rhs)
        vt = uinf * pan.tx + vinf * pan.ty
        vt = vt + lane_mm(op.at_full, gamma)
    if sigma is not None:
        vt = vt + lane_mm(op.bt, sigma)

    cp = 1.0 - vt * vt

    # dF = Cp * n_in * ds.
    ds = pan.length
    fx = torch.sum(cp * pan.nx * ds, -1)
    fy = torch.sum(cp * pan.ny * ds, -1)
    cl = fy * ca - fx * sa
    cd = fx * ca + fy * sa
    # Pitching moment about quarter chord, positive nose-up.
    xref, yref = 0.25, 0.0
    cm = -torch.sum(
        cp * ds * ((pan.xm - xref) * pan.ny - (pan.ym - yref) * pan.nx), -1)

    gam_avg = 0.5 * (gamma[..., :-1] + gamma[..., 1:])
    circulation = torch.sum(gam_avg * ds, -1)

    return InviscidSolution(gamma, vt, cp, cl, cm, cd, circulation)


def velocity_at_points(
    px: torch.Tensor,
    py: torch.Tensor,
    op: InviscidOperator,
    gamma: torch.Tensor,
    alpha_deg,
    sigma: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Off-body velocity field at arbitrary points (flow-field backend)."""
    pan = op.pan
    xi, eta, l = _local_frame(px, py, pan)
    u_c, v_c, u_r, v_r, u_s, v_s = _kernels(xi, eta, l)
    ua, va = _to_global(u_c - u_r, v_c - v_r, pan)
    ub, vb = _to_global(u_r, v_r, pan)
    us, vs = _to_global(u_s, v_s, pan)

    uinf, vinf = _freestream(alpha_deg, px)
    ga = gamma[:-1][None, :]
    gb = gamma[1:][None, :]
    u = uinf + torch.sum(ua * ga + ub * gb, dim=1)
    v = vinf + torch.sum(va * ga + vb * gb, dim=1)
    u_te, v_te = _te_maps(px, py, pan)
    g_te = gamma[0] - gamma[-1]
    u = u + u_te * g_te
    v = v + v_te * g_te
    if sigma is not None:
        u = u + us @ sigma
        v = v + vs @ sigma
    return u, v
