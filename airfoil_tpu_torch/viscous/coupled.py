"""Viscous-inviscid coupled airfoil solve (direct, under-relaxed): port of
``airfoil_tpu/viscous/coupled.py``.

1. One inviscid solve fixes the edge-velocity baseline and the operator's
   sensitivities to body and wake transpiration.
2. The surface is split at the stagnation point and each side's edge
   velocity is sampled onto a fixed station grid.
3. The side pair is marched as two lanes of one march (``viscous.kernel``:
   the CUDA kernel on a CUDA tensor), the merged TE state continues down
   the wake, and the displacement bodies return as transpiration sources.
4. Steps 2-3 repeat ``coupling_iters`` under-relaxed passes; the sources
   are averaged over the last two thirds of them (the iteration settles
   into a small limit cycle), and convergence is judged by the CL spread
   over that window and the separated fraction.
5. CD is Squire-Young at the wake end, the friction part the integral of
   Cf; Cp, CL and Cm come from the final transpired surface speeds.

The coupling loop reads nothing back to the host: ``converged`` stays a
bool tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from airfoil_tpu_torch.device import DTYPE
from airfoil_tpu_torch.inviscid.panel_solver import (
    InviscidOperator,
    _freestream,
    solve_inviscid,
)
from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.numerics import clip, gradient, interp, nanmax, nanmin
from airfoil_tpu_torch.viscous import kernel
from airfoil_tpu_torch.viscous.march import BLState, wake_ctau0
from airfoil_tpu_torch.viscous.wake import (
    WakeOperator,
    blend_te_continuity,
    build_wake_operator,
)

__all__ = ["SideBL", "ViscousResult", "solve_viscous"]


class SideBL(NamedTuple):
    """Boundary-layer arrays along one side, stagnation -> trailing edge."""

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor        # arc distance from stagnation point
    ue: torch.Tensor       # edge velocity / U_inf (final coupled)
    theta: torch.Tensor
    dstar: torch.Tensor
    hk: torch.Tensor
    cf: torch.Tensor
    turb: torch.Tensor
    x_transition: torch.Tensor


class ViscousResult(NamedTuple):
    cl: torch.Tensor
    cd: torch.Tensor
    cdp: torch.Tensor      # pressure (form) drag = cd - cd_friction
    cm: torch.Tensor
    cp: torch.Tensor       # (N,) viscous Cp at panel midpoints
    upper: SideBL
    lower: SideBL
    converged: torch.Tensor       # bool
    sep_fraction: torch.Tensor    # fraction of stations with Hk cap engaged
    sigma: torch.Tensor           # (N,) final body transpiration strengths
    sigma_wake: torch.Tensor      # (Mw,) final wake transpiration strengths


def _at(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``a[j]`` for a 0-d index tensor without a host read."""
    return a[j.reshape(1)][0]


def _station_fractions(m: int, dtype=DTYPE, device=None) -> torch.Tensor:
    """Station spacing, clustered at the stagnation point only."""
    u = torch.linspace(0.0, 1.0, m + 1, dtype=dtype, device=device)[1:]
    return u ** 1.6


def _find_stagnation(s_mid, vt, s_le):
    """Arc position of the Vt sign change (- on upper, + on lower side)
    nearest the leading edge ``s_le``."""
    n = vt.shape[0]
    crossing = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=vt.device),
        (vt[:-1] < 0.0) & (vt[1:] >= 0.0),
    ])
    dist = torch.abs(s_mid - s_le) + torch.where(crossing, 0.0, 1e6)
    j = torch.argmin(dist).clamp(1, n - 1)
    v0 = _at(vt, j - 1)
    v1 = _at(vt, j)
    dv = v1 - v0
    frac = clip(-v0 / torch.where(torch.abs(dv) < 1e-12, 1e-12, dv),
                0.0, 1.0)
    s0 = _at(s_mid, j - 1)
    return s0 + frac * (_at(s_mid, j) - s0)


def _sample_side(s_mid, values, s_query):
    return interp(s_query, s_mid, values)


# Edge-velocity queries stop this fraction of the side's arc length short of
# the trailing edge (the corner stagnation of a finite-angle TE is below the
# boundary-layer scale; see the reference).
_TE_UE_MARGIN = 0.01


def _side_stations(pan, vt, s0, upper: bool, m: int):
    """Station grid (arc xi from stagnation), the clamped ue query
    positions, Ue, x, y for one side."""
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s_in = s_mid[1:-1]
    vt_in = vt[1:-1]
    frac = _station_fractions(m, vt.dtype, vt.device)
    if upper:
        length = s0 - pan.s[0]
        xi = frac * length
        s_q = s0 - xi
        s_q_ue = torch.maximum(s_q, pan.s[0] + _TE_UE_MARGIN * length)
        ue = -_sample_side(s_in, vt_in, s_q_ue)
    else:
        length = pan.s[-1] - s0
        xi = frac * length
        s_q = s0 + xi
        s_q_ue = torch.minimum(s_q, pan.s[-1] - _TE_UE_MARGIN * length)
        ue = _sample_side(s_in, vt_in, s_q_ue)
    ue = clip(ue, 0.02)
    x = _sample_side(s_mid, pan.xm, s_q)
    y = _sample_side(s_mid, pan.ym, s_q)
    return xi, s_q_ue, ue, x, y


def _smooth_clip_derivative(xi, mval, clip_at=2.0):
    """d(m)/d(xi) along the last axis, lightly smoothed (two 1-2-1 passes)
    and clipped: the direct coupling iteration is only neutrally stable
    against short-wave sigma modes."""
    d = gradient(mval) / clip(gradient(xi), 1e-9)
    for _ in range(2):
        d = torch.cat([d[..., :1], 0.25 * d[..., :-2] + 0.5 * d[..., 1:-1]
                       + 0.25 * d[..., 2:], d[..., -1:]], -1)
    return clip(d, -clip_at, clip_at)


def _sigma_from_sides(pan, s0, xi_u, m_u, xi_l, m_l):
    """Per-side mass defect m = Ue*dstar -> panel source strengths
    (smoothed-gradient variant of the direct iteration). With a lane axis
    ``s0`` is (P,), the station arrays (P, M) and ``pan`` shared or one a
    lane."""
    sig_u = _smooth_clip_derivative(xi_u, m_u)
    sig_l = _smooth_clip_derivative(xi_l, m_l)
    s_mid = 0.5 * (pan.s[..., :-1] + pan.s[..., 1:])
    s0 = s0[..., None]
    xi_panel_u = clip(s0 - s_mid, 0.0)
    xi_panel_l = clip(s_mid - s0, 0.0)
    return torch.where(s_mid < s0, interp(xi_panel_u, xi_u, sig_u),
                       interp(xi_panel_l, xi_l, sig_l))


def _with_zero(m):
    """``m`` (..., M), a tensor or ``Dual``, with a 0 put before its
    first station."""
    v = nm.value(m)
    return nm.cat([v.new_zeros((*v.shape[:-1], 1)), m])


def _sigma_nodal_from_sides(pan, s0, xi_u, m_u, xi_l, m_l, clip_at=2.0):
    """Panel-consistent transpiration sources (XFOIL-style, no smoothing):
    the station mass defects interpolated to the panel nodes (m(0) = 0 at
    the stagnation point), differenced per panel in the flow direction;
    the panel straddling the stagnation point emits both sides' outflow.
    ``m_u``, ``m_l`` may carry leading batch axes or be ``Dual``s; with a
    lane axis ``s0`` is (P,) and the station arrays (P, M)."""
    s_nodes = pan.s
    s0 = s0[..., None]
    m_up = interp(clip(s0 - s_nodes, 0.0), _with_zero(xi_u), _with_zero(m_u))
    m_lo = interp(clip(s_nodes - s0, 0.0), _with_zero(xi_l), _with_zero(m_l))
    m_nodes = nm.where(s_nodes < s0, m_up, m_lo)
    ds = clip(s_nodes[..., 1:] - s_nodes[..., :-1], 1e-9)
    dm = m_nodes[..., 1:] - m_nodes[..., :-1]
    fully_upper = s_nodes[..., 1:] <= s0
    fully_lower = s_nodes[..., :-1] >= s0
    # The arc runs TE -> LE -> TE: sigma = -dm/ds on the upper side.
    sigma = nm.where(
        fully_upper, -dm / ds,
        nm.where(fully_lower, dm / ds,
                 (m_nodes[..., :-1] + m_nodes[..., 1:]) / ds))
    return clip(sigma, -clip_at, clip_at)


def _sigma_wake_nodal(wpan, xi_w, m_w, m_te, clip_at=2.0):
    """Panel-consistent wake sources, anchored at the TE with the merged
    body mass defect ``m_te`` (batch axes and ``Dual``s as above)."""
    s_rel = wpan.s - wpan.s[..., :1]
    m_nodes = interp(s_rel, _with_zero(xi_w), nm.cat([m_te[..., None], m_w]))
    ds = clip(s_rel[..., 1:] - s_rel[..., :-1], 1e-9)
    return clip((m_nodes[..., 1:] - m_nodes[..., :-1]) / ds,
                -clip_at, clip_at)


def _forces_from_cp(pan, cp, alpha_deg):
    """Integrate surface Cp to (cl, cm, cd_pressure); with a lane axis
    ``cp`` is (P, N), ``alpha_deg`` (P,) and ``pan`` shared or one a
    lane."""
    ds = pan.length
    fx = torch.sum(cp * pan.nx * ds, -1)
    fy = torch.sum(cp * pan.ny * ds, -1)
    ca, sa = _freestream(alpha_deg, cp)
    cl = fy * ca - fx * sa
    cdp = fx * ca + fy * sa
    cm = -torch.sum(cp * ds * ((pan.xm - 0.25) * pan.ny - pan.ym * pan.nx),
                    -1)
    return cl, cm, cdp


def _lane(bl: BLState, i: int) -> BLState:
    return BLState(*(a[i] for a in bl))


def solve_viscous(
    op: InviscidOperator,
    alpha_deg,
    reynolds,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    n_stations: int = 80,
    n_wake: int = 24,
    coupling_iters: int = 24,
    relax: float = 0.3,
) -> ViscousResult:
    """Coupled viscous solve at one (alpha, Re) on the operator's device.

    Makes 2 x (``coupling_iters`` + 1) march calls (side pair, wake), each
    one launch of the CUDA march kernel on a CUDA device.
    """
    pan = op.pan
    dtype, dev = pan.xm.dtype, pan.xm.device
    # Scalars go to the device once, before the loop.
    alpha_deg = torch.as_tensor(alpha_deg, dtype=dtype, device=dev)
    nu = 1.0 / torch.as_tensor(reynolds, dtype=dtype, device=dev)

    sol0 = solve_inviscid(op, alpha_deg)
    vt0 = sol0.vt
    n = vt0.shape[0]
    m = n_stations

    wop: WakeOperator = build_wake_operator(op, alpha_deg, n_wake=n_wake)
    te_gap = torch.hypot(pan.xp[0] - pan.xp[-1], pan.yp[0] - pan.yp[-1])

    s_le = _at(pan.s, torch.argmin(pan.xp))
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])

    def march_all(sigma_b, sigma_w):
        vt = vt0 + op.due_dsigma @ sigma_b + wop.dvt_dsigw @ sigma_w
        s0 = _find_stagnation(s_mid, vt, s_le)
        xi_u, _sq, ue_u, x_u, y_u = _side_stations(pan, vt, s0, True, m)
        xi_l, _sq, ue_l, x_l, y_l = _side_stations(pan, vt, s0, False, m)
        # The two sides are two lanes of one march.
        bl2 = kernel.march_side(torch.stack([xi_u, xi_l]),
                                torch.stack([ue_u, ue_l]),
                                torch.stack([x_u, x_l]),
                                nu, n_crit, x_forced_transition)
        bl_u, bl_l = _lane(bl2, 0), _lane(bl2, 1)

        ue_te = 0.5 * (ue_u[-1] + ue_l[-1])
        ue_w = wop.uw0 + wop.wb @ sigma_b + wop.ww @ sigma_w
        ue_w = clip(blend_te_continuity(wop.xi, ue_w, ue_te), 0.05)
        th0 = bl_u.theta[-1] + bl_l.theta[-1]
        ds0 = bl_u.dstar[-1] + bl_l.dstar[-1] + te_gap

        ct0 = wake_ctau0(bl_u, bl_l, th0, ds0, ue_te, nu)
        th_w, ds_w, hk_w = kernel.march_wake(wop.xi, ue_w, nu, th0, ds0, ct0)

        return vt, s0, (xi_u, ue_u, x_u, y_u, bl_u), \
            (xi_l, ue_l, x_l, y_l, bl_l), (ue_w, th_w, ds_w, hk_w)

    # The iteration settles into a small limit cycle around the fixed
    # point; averaging the iterates over the tail extracts its centre, and
    # the CL spread across the window judges convergence.
    avg_from = coupling_iters // 3
    sigma_b = torch.zeros(n, dtype=dtype, device=dev)
    sigma_w = torch.zeros(n_wake, dtype=dtype, device=dev)
    acc_b = torch.zeros_like(sigma_b)
    acc_w = torch.zeros_like(sigma_w)
    cl_window = []
    for it in range(coupling_iters):
        vt, s0, up, lo, wake = march_all(sigma_b, sigma_w)
        xi_u, ue_u, _xu, _yu, bl_u = up
        xi_l, ue_l, _xl, _yl, bl_l = lo
        ue_w, th_w, ds_w, _hk_w = wake

        sb_new = _sigma_from_sides(pan, s0, xi_u, ue_u * bl_u.dstar,
                                   xi_l, ue_l * bl_l.dstar)
        sw_new = _smooth_clip_derivative(wop.xi, ue_w * ds_w)
        sb_new = torch.where(torch.isfinite(sb_new), sb_new, sigma_b)
        sw_new = torch.where(torch.isfinite(sw_new), sw_new, sigma_w)

        sigma_b = sigma_b + relax * (sb_new - sigma_b)
        sigma_w = sigma_w + relax * (sw_new - sigma_w)

        if it >= avg_from:
            acc_b = acc_b + sigma_b
            acc_w = acc_w + sigma_w
            vt_now = vt0 + op.due_dsigma @ sigma_b + wop.dvt_dsigw @ sigma_w
            cl_it, _cm, _cdp = _forces_from_cp(pan, 1.0 - vt_now ** 2,
                                               alpha_deg)
            cl_window.append(cl_it)

    n_avg = coupling_iters - avg_from
    sigma_b = acc_b / n_avg
    sigma_w = acc_w / n_avg
    cl_window = torch.stack(cl_window)
    cl_spread = nanmax(cl_window) - nanmin(cl_window)

    # Final state at the settled transpiration.
    vt, s0, up, lo, wake = march_all(sigma_b, sigma_w)
    xi_u, ue_u, x_u, y_u, bl_u = up
    xi_l, ue_l, x_l, y_l, bl_l = lo
    ue_w, th_w, ds_w, hk_w = wake

    cp = 1.0 - vt * vt
    cl, cm, _cdp_raw = _forces_from_cp(pan, cp, alpha_deg)

    # Squire-Young extrapolation from the wake end.
    h_end = clip(hk_w[-1], 1.0, 2.5)
    ue_end = clip(ue_w[-1], 0.2, 1.5)
    cd = 2.0 * th_w[-1] * ue_end ** (0.5 * (h_end + 5.0))

    def friction_drag(bl: BLState, ue, x):
        integrand = bl.cf * ue ** 2
        return torch.sum(0.5 * (integrand[1:] + integrand[:-1])
                         * torch.abs(torch.diff(x)))

    cdf = friction_drag(bl_u, ue_u, x_u) + friction_drag(bl_l, ue_l, x_l)
    cdp = cd - cdf

    sep_u = torch.mean(bl_u.separated.to(dtype))
    sep_l = torch.mean(bl_l.separated.to(dtype))
    sep_fraction = 0.5 * (sep_u + sep_l)

    finite = (torch.isfinite(sigma_b).all() & torch.isfinite(sigma_w).all()
              & torch.isfinite(cl) & torch.isfinite(cd))
    converged = finite & (cl_spread < 0.12) & (sep_fraction < 0.12)

    def side(bl: BLState, xi, ue, x, y) -> SideBL:
        return SideBL(x=x, y=y, s=xi, ue=ue, theta=bl.theta,
                      dstar=bl.dstar, hk=bl.hk, cf=bl.cf, turb=bl.turb,
                      x_transition=bl.x_transition)

    return ViscousResult(
        cl=cl, cd=cd, cdp=cdp, cm=cm, cp=cp,
        upper=side(bl_u, xi_u, ue_u, x_u, y_u),
        lower=side(bl_l, xi_l, ue_l, x_l, y_l),
        converged=converged, sep_fraction=sep_fraction,
        sigma=sigma_b, sigma_wake=sigma_w,
    )
