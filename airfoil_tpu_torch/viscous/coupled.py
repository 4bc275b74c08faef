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
bool tensor. So the whole solve past its host part (``_direct_body``) is
one program of ``viscous.graphs``: on the card one CUDA graph a shape key,
captured once and replayed, as the reference's one ``jax.jit`` program a
shape; on the CPU the same body eagerly.

Geometries are lanes (the reference's ``vmap`` of the solve over
geometries, ``bench/parser_benchmark.py``): ``solve_viscous`` takes one
operator, one with a lane axis, or a list of B operators (stacked), and
each coupling pass is one side march of 2B lanes (the upper sides, then
the lower ones) and one wake march of B lanes, whatever B is. Every other
step acts lane by lane, so a lane's result does not depend on the others
(a non-finite lane stays in its lane). On the card a lane equals its
one-geometry solve up to how the library batches reductions; on the CPU
it equals it bit for bit below 16 geometries (torch's CPU ``pow`` of 32
elements or more, in the march's closures, takes a vectorised path that
rounds differently from its one-element path).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from airfoil_tpu_torch.device import DTYPE
from airfoil_tpu_torch.inviscid.panel_solver import (
    InviscidOperator,
    _freestream,
    lane_mm,
    solve_inviscid,
)
from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.numerics import clip, gradient, interp, nanmax, nanmin
from airfoil_tpu_torch.viscous import graphs, kernel
from airfoil_tpu_torch.viscous.march import BLState, wake_ctau0
from airfoil_tpu_torch.viscous.wake import (
    WakeOperator,
    blend_te_continuity,
    build_wake_operator,
)

__all__ = ["SideBL", "ViscousResult", "solve_viscous", "stack_lanes"]


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
    """``a[..., j]`` for an index tensor of ``a``'s lane shape (0-d for
    one geometry) without a host read."""
    return torch.take_along_dim(a, j[..., None], -1)[..., 0]


def _station_fractions(m: int, dtype=DTYPE, device=None) -> torch.Tensor:
    """Station spacing, clustered at the stagnation point only."""
    u = torch.linspace(0.0, 1.0, m + 1, dtype=dtype, device=device)[1:]
    return u ** 1.6


def _find_stagnation(s_mid, vt, s_le):
    """Arc position of the Vt sign change (- on upper, + on lower side)
    nearest the leading edge ``s_le`` (one a lane)."""
    n = vt.shape[-1]
    crossing = torch.cat([
        torch.zeros((*vt.shape[:-1], 1), dtype=torch.bool, device=vt.device),
        (vt[..., :-1] < 0.0) & (vt[..., 1:] >= 0.0),
    ], -1)
    dist = torch.abs(s_mid - s_le[..., None]) + torch.where(crossing, 0.0,
                                                            1e6)
    j = torch.argmin(dist, -1).clamp(1, n - 1)
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
    positions, Ue, x, y for one side (of each lane)."""
    s_mid = 0.5 * (pan.s[..., :-1] + pan.s[..., 1:])
    s_in = s_mid[..., 1:-1]
    vt_in = vt[..., 1:-1]
    frac = _station_fractions(m, vt.dtype, vt.device)
    s0 = s0[..., None]
    if upper:
        length = s0 - pan.s[..., :1]
        xi = frac * length
        s_q = s0 - xi
        s_q_ue = torch.maximum(s_q, pan.s[..., :1] + _TE_UE_MARGIN * length)
        ue = -_sample_side(s_in, vt_in, s_q_ue)
    else:
        length = pan.s[..., -1:] - s0
        xi = frac * length
        s_q = s0 + xi
        s_q_ue = torch.minimum(s_q, pan.s[..., -1:] - _TE_UE_MARGIN * length)
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


def _side_of(bl2: BLState, i: int, lanes) -> BLState:
    """Side ``i`` (0 upper, 1 lower) of a march of 2B lanes (the upper
    sides, then the lower ones), with the geometries' lane shape."""
    return BLState(*(a.reshape(2, *lanes, *a.shape[1:])[i] for a in bl2))


def stack_lanes(trees):
    """Equal NamedTuples (of NamedTuples) of tensors, one a lane, as one
    with a lane axis in front of every field."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    return type(first)(*(stack_lanes(f) for f in zip(*trees)))


def _read_fields(op: InviscidOperator) -> InviscidOperator:
    """``op`` with None for the fields that only a solve with transpiration
    sources reads (``bn``, ``at_a``, ``at_b``, ``bt``): what the direct
    solve and the Newton set-up read of an operator, and so all that their
    graphs copy in."""
    return op._replace(bn=None, at_a=None, at_b=None, bt=None)


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

    ``op`` is one operator, one with a lane axis (B geometries) or a
    sequence of B operators; the result then has the lane axis in front of
    every field. Makes 2 x (``coupling_iters`` + 1) march calls (sides,
    wake), each one launch of the CUDA march kernel on a CUDA device,
    whatever B is.

    The host part: the operators stacked, the numbers made tensors on the
    device. The rest (``_direct_body``) is one program of the port's
    compiled-program layer (``viscous.graphs``): on the card the replay of
    its CUDA graph, captured once a key (device, lane shape, panels,
    ``n_stations``, ``n_wake``, ``coupling_iters``, ``relax`` and the
    numbers' shapes), on the CPU the same body eagerly.
    """
    if not isinstance(op, InviscidOperator):
        op = stack_lanes(list(op))
    xm = op.pan.xm
    dev = xm.device
    # Every number of a call is a tensor before the body: one made inside
    # it would be frozen into the graph at its capture.
    alpha, re, n_crit_t, x_tr = (graphs.as_input(v, xm) for v in (
        alpha_deg, reynolds, n_crit, x_forced_transition))
    scalars = (alpha, 1.0 / re, n_crit_t, x_tr)
    flat, spec = graphs.flatten((_read_fields(op), *scalars))
    key = (dev, tuple(xm.shape[:-1]), xm.shape[-1], n_stations, n_wake,
           coupling_iters, relax, tuple(tuple(a.shape) for a in scalars))
    return graphs.run("direct", key, functools.partial(
        _direct_body, spec, n_stations, n_wake, coupling_iters, relax), flat)


def _direct_body(spec, n_stations: int, n_wake: int, coupling_iters: int,
                 relax: float, flat) -> ViscousResult:
    """The direct solve as a plain function of the flat list of its
    operator and its numbers (``spec`` their structure): what a CUDA
    graph captures, and what runs eagerly on the CPU."""
    op, alpha_deg, nu, n_crit, x_forced_transition = graphs.unflatten(
        spec, flat)
    pan = op.pan
    lanes = pan.xm.shape[:-1]
    dtype, dev = pan.xm.dtype, pan.xm.device

    sol0 = solve_inviscid(op, alpha_deg)
    vt0 = sol0.vt
    n = vt0.shape[-1]
    m = n_stations

    wop: WakeOperator = build_wake_operator(op, alpha_deg, n_wake=n_wake)
    te_gap = torch.hypot(pan.xp[..., 0] - pan.xp[..., -1],
                         pan.yp[..., 0] - pan.yp[..., -1])

    s_le = _at(pan.s, torch.argmin(pan.xp, -1))
    s_mid = 0.5 * (pan.s[..., :-1] + pan.s[..., 1:])

    def sides(a, b):
        return torch.stack([a, b]).reshape(-1, m)

    def march_all(sigma_b, sigma_w):
        vt = (vt0 + lane_mm(op.due_dsigma, sigma_b)
              + lane_mm(wop.dvt_dsigw, sigma_w))
        s0 = _find_stagnation(s_mid, vt, s_le)
        xi_u, _sq, ue_u, x_u, y_u = _side_stations(pan, vt, s0, True, m)
        xi_l, _sq, ue_l, x_l, y_l = _side_stations(pan, vt, s0, False, m)
        # Every side is a lane of one march.
        bl2 = kernel.march_side(sides(xi_u, xi_l), sides(ue_u, ue_l),
                                sides(x_u, x_l), nu, n_crit,
                                x_forced_transition)
        bl_u, bl_l = _side_of(bl2, 0, lanes), _side_of(bl2, 1, lanes)

        ue_te = 0.5 * (ue_u[..., -1] + ue_l[..., -1])
        ue_w = (wop.uw0 + lane_mm(wop.wb, sigma_b)
                + lane_mm(wop.ww, sigma_w))
        ue_w = clip(blend_te_continuity(wop.xi, ue_w, ue_te[..., None]),
                    0.05)
        th0 = bl_u.theta[..., -1] + bl_l.theta[..., -1]
        ds0 = bl_u.dstar[..., -1] + bl_l.dstar[..., -1] + te_gap

        ct0 = wake_ctau0(bl_u, bl_l, th0, ds0, ue_te, nu)
        th_w, ds_w, hk_w = kernel.march_wake(wop.xi, ue_w, nu, th0, ds0, ct0)

        return vt, s0, (xi_u, ue_u, x_u, y_u, bl_u), \
            (xi_l, ue_l, x_l, y_l, bl_l), (ue_w, th_w, ds_w, hk_w)

    # The iteration settles into a small limit cycle around the fixed
    # point; averaging the iterates over the tail extracts its centre, and
    # the CL spread across the window judges convergence.
    avg_from = coupling_iters // 3
    sigma_b = torch.zeros((*lanes, n), dtype=dtype, device=dev)
    sigma_w = torch.zeros((*lanes, n_wake), dtype=dtype, device=dev)
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
            vt_now = (vt0 + lane_mm(op.due_dsigma, sigma_b)
                      + lane_mm(wop.dvt_dsigw, sigma_w))
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
    h_end = clip(hk_w[..., -1], 1.0, 2.5)
    ue_end = clip(ue_w[..., -1], 0.2, 1.5)
    cd = 2.0 * th_w[..., -1] * ue_end ** (0.5 * (h_end + 5.0))

    def friction_drag(bl: BLState, ue, x):
        integrand = bl.cf * ue ** 2
        return torch.sum(0.5 * (integrand[..., 1:] + integrand[..., :-1])
                         * torch.abs(torch.diff(x, dim=-1)), -1)

    cdf = friction_drag(bl_u, ue_u, x_u) + friction_drag(bl_l, ue_l, x_l)
    cdp = cd - cdf

    sep_u = torch.mean(bl_u.separated.to(dtype), -1)
    sep_l = torch.mean(bl_l.separated.to(dtype), -1)
    sep_fraction = 0.5 * (sep_u + sep_l)

    finite = (torch.isfinite(sigma_b).all(-1)
              & torch.isfinite(sigma_w).all(-1)
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
