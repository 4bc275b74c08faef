"""Simultaneous-Newton viscous-inviscid coupling: port of the default path
of ``airfoil_tpu/viscous/newton.py``.

The integral boundary-layer equations on both surfaces and the wake, the
e^N amplification factor and the edge-velocity interaction law are solved
as one nonlinear system (4 unknowns a station: ln theta, ln m, ln ctau, n)
by Levenberg-Marquardt. See the reference module for the physics and for
why the design is what it is; the port keeps its equations, constants,
clamps and gates in the same order.

What the port leaves out: the reference's seven round-4 mechanism gates
(``_ORACLE_RESEED`` to ``_DONOR_CEIL``) are all off there, so only their
off branch is here, and the in-loop oracle probe and reseed and the debug
prints, which only those gates or environment variables reach, are gone.
``solve_polar_point_cont`` takes the reference's continuation slacks,
which only the donor-ceiling gate reads.

How it runs on the card:

- P points solve side by side as lanes (``solve_polar_points``, the
  reference's ``vmap`` of ``solve_polar_point``): the grid, ``vt0``, the
  wake operator and the states carry a leading lane axis, the inviscid
  operator is shared (a polar) or stacked one a lane (a batch of
  geometries), and the per-lane setup is a host loop over the lanes whose
  results are stacked. Every lane runs the same LM iterations a round; a
  settled lane keeps its carry frozen, as under the reference's
  ``while_loop``. The single-point entry points are the one-lane case.
- Every residual function takes tensors with leading batch axes (the LM
  candidates are one batch, as the reference's ``vmap``, in front of the
  lanes) or a ``numerics.Dual``. The structured Jacobian is two residual
  evaluations on ``Dual``s seeded with the 24 z-colours and the 6
  ue-colours of ``_seed_plan`` (``jax.jacfwd`` of ``r_of_cz``/
  ``r_of_cu``), scattered into the (4 S, 4 S) matrix, plus the
  interaction law's part through
  ``l_mat``, the interaction operator's Jacobian over the station mass
  defects, built once a solve from one ``Dual`` evaluation.
- One LM iteration (``_System.lm_step``) reads nothing back to the host:
  ``torch.linalg.cholesky_ex`` without its error check, the factor of a
  matrix that is not positive definite set to NaN (JAX's Cholesky returns
  NaNs there, and the candidate then takes no step), two triangular
  solves, and the candidate chosen by ``torch.where``/``argmax`` on the
  device. The only host reads of a solve are the round loop's lane mask,
  once a round, and what the caller reads of the result.
- The solve is five programs of ``viscous.graphs``, each a plain
  function of a flat list of tensors: the lanes' set-up and warm start
  (``_prepare_body``), a round's re-projection (``_reproject_body``), its
  LM iterations (``_lm_body``: the state, the damping and
  ``_System.lm_tensors``, replayed ``newton_iters`` times a round), its
  residual and lane bookkeeping (``_settle_body``) and the answer
  (``_answer_body``). On the card each is captured once a shape key as a
  CUDA graph and replayed (the counterpart of the reference's ``jax.jit``
  programs); on the CPU the same bodies run eagerly. The lane values are
  made before the bodies, so no number a call varies is frozen into a
  graph.
- The boundary-layer marches (the warm start's side marches of 2P lanes
  at the solve's station count, the verdict's, and the fallback's wake
  march of P lanes) go through ``viscous.kernel``: the CUDA march kernel
  on a CUDA tensor, the plain march on a CPU tensor. One solve makes
  ``warm_iters`` + 2 side marches and one wake march, whatever P.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.inviscid.panel_solver import (
    InviscidOperator,
    solve_inviscid,
)
from airfoil_tpu_torch.numerics import clip, maximum, minimum
from airfoil_tpu_torch.paneling import Paneling
from airfoil_tpu_torch.viscous import closures as cl
from airfoil_tpu_torch.viscous import graphs, kernel
from airfoil_tpu_torch.viscous.coupled import (
    SideBL,
    ViscousResult,
    _at,
    _find_stagnation,
    _forces_from_cp,
    _read_fields,
    _side_stations,
    _sigma_from_sides,
    _sigma_nodal_from_sides,
    _sigma_wake_nodal,
    _smooth_clip_derivative,
    stack_lanes,
)
from airfoil_tpu_torch.viscous.march import BLState, wake_ctau0
from airfoil_tpu_torch.viscous.wake import (
    WakeOperator,
    blend_te_continuity,
    build_wake_operator,
)

__all__ = ["solve_viscous_newton", "solve_polar_point", "solve_polar_points",
           "solve_viscous_newton_cont", "solve_polar_point_cont",
           "state_from_numpy"]

_AVG_W = 0.65          # implicit interval weighting (0.5 = trapezoid)
_KLAG = 5.6
_TR_WIDTH = 0.012      # chordwise half-width of the forced-trip ramp
_W_N = 0.20            # n-width of the free-transition blend sigmoid
_N_VARS = 4            # (ln theta, ln m, ln ctau, n) per station
_RMS_OK = 0.035        # convergence verdict and the round loop's exit
_FUTILITY = 0.92       # a round with less relative progress ends the loop
_CD_HI_COEF = 0.25     # CD-ceiling wrong-basin guard
_CD_HI_SEP = 0.30
_CONT_ROUNDS = 3       # continuation LM restart-round cap
_UE_FLOOR_BODY = 0.02
_UE_FLOOR_WAKE = 0.05
_SF_BETA = 60.0
_LAM_FACTORS = (0.33, 1.0, 8.0, 64.0)   # the LM candidates' dampings
# Per-variable step limits: tight on the thickness logs, loose on ln ctau
# and on n.
_STEP_CLIP = (0.25, 0.25, 1.0, 2.0)


def _avg(f1, f2):
    return (1.0 - _AVG_W) * f1 + _AVG_W * f2


def _station_closures(theta, dstar, ue, nu, ctau, w, wake: bool):
    """Blended closure set at every station (elementwise); ``w`` the
    turbulence weight in [0, 1]. In the wake (no wall) Cf = 0 and the
    dissipation is the shear term alone."""
    theta = maximum(theta, 1e-10)
    hk = clip(dstar / theta, 1.005, 12.0)
    ret = maximum(ue * theta / nu, 1.0)

    # The laminar branch saturates at the separated-shear value; the
    # turbulent one keeps the full range (see the reference).
    hk_l = minimum(hk, cl.HK_LAM_MAX)
    hs_l = cl.lam_hstar(hk_l)
    hs_t = cl.turb_hstar(hk, ret)
    hs = (1.0 - w) * hs_l + w * hs_t

    cf_l = cl.lam_cf(hk_l, ret)
    cf_t = cl.turb_cf(hk, ret)
    cf = (1.0 - w) * cf_l + w * cf_t

    cd_l = cl.lam_diss(hk_l, ret, hs_l)
    cd_t = cl.turb_diss(hk, ret, ctau, hs_t)
    cd = (1.0 - w) * cd_l + w * cd_t

    if wake:
        us = cl.turb_us(hk, hs_t)
        cf = nm.zeros_like(cf)
        cd = clip(ctau, 0.0, 0.3) * (1.0 - us)
    return hk, ret, hs, cf, cd


class _Grid(NamedTuple):
    """Frozen station geometry for the Newton solve (upper+lower+wake)."""

    xi_u: torch.Tensor
    xi_l: torch.Tensor
    xi_w: torch.Tensor
    x_u: torch.Tensor
    y_u: torch.Tensor
    x_l: torch.Tensor
    y_l: torch.Tensor
    s_q_u: torch.Tensor     # arc positions of upper stations on the loop
    s_q_l: torch.Tensor
    s0: torch.Tensor        # frozen stagnation arc position
    te_gap: torch.Tensor
    # Trip coordinates: chordwise x masked to -1 before the LE, which every
    # trip comparison uses (the strip wraps around the LE).
    xt_u: torch.Tensor
    xt_l: torch.Tensor


def _n_sat_gate(n, n_crit):
    """Soft saturation gate of the amplification ODE: ~1 through the
    n_crit crossing, -> 0 towards the n_crit + 3 clip."""
    return nm.sigmoid((n_crit + 2.5 - n) / 0.4)


def _interval_residuals(s, ue, z, nu, w, wake: bool, n_crit=9.0):
    """Residuals of all intervals of one strip, (..., *L, M-1, 4):
    momentum, kinetic energy, shear lag, amplification. ``z``
    (..., *L, M, 4), ``ue`` and ``w`` (..., *L, M), ``s`` (*L, M); ``nu``
    and ``n_crit`` broadcast over the stations ((*L, 1)). ``L`` is the lane
    shape: () for one point, (P,) for P points solved side by side."""
    theta = nm.exp(z[..., 0])
    m = nm.exp(z[..., 1])
    ctau = nm.exp(clip(z[..., 2], -20.0, 0.0))
    dstar = m / maximum(ue, 0.02)

    hk, ret, hs, cf, cd = _station_closures(theta, dstar, ue, nu, ctau, w,
                                            wake)

    ds = clip(s[..., 1:] - s[..., :-1], 1e-8)
    due = ue[..., 1:] - ue[..., :-1]
    # The reference's interval weight: a float32 constant, so its
    # complement is formed in float32 too.
    uw = nm._const(_AVG_W, ds)
    uw1 = 1.0 - uw

    def iv(f):
        return uw1 * f[..., :-1] + uw * f[..., 1:]

    ue_m = iv(ue)
    t_m = iv(theta)
    h_m = iv(hk)
    hs_m = iv(hs)
    cf_m = iv(cf)
    cd_m = iv(cd)

    # 1) von Karman momentum integral.
    r1 = ((theta[..., 1:] - theta[..., :-1]) / ds
          + (2.0 + h_m) * (t_m / ue_m) * (due / ds) - 0.5 * cf_m)
    # 2) kinetic-energy shape-parameter equation.
    r2 = (t_m * (hs[..., 1:] - hs[..., :-1]) / ds
          + hs_m * (1.0 - h_m) * (t_m / ue_m) * (due / ds)
          - (2.0 * cd_m - hs_m * 0.5 * cf_m))

    # 3) shear-stress transport: the lag ODE downstream of transition,
    # relaxing towards the reset (Hk ~ 1.5) equilibrium upstream.
    hs_t = cl.turb_hstar(hk, ret)
    cteq = cl.turb_cteq(hk, ret, hs_t)
    delta = cl.delta_thickness(theta, dstar, hk)
    lag = _KLAG * (nm.sqrt(cteq) - nm.sqrt(ctau)) / (2.0 * delta)
    lag = clip(lag, -40.0, 40.0)
    hk_eq = clip(hk, 1.005, 1.55)
    hs_eq = cl.turb_hstar(hk_eq, ret)
    cteq_eq = cl.turb_cteq(hk_eq, ret, hs_eq)
    a_eq = nm.log(clip(0.7 * cteq_eq, 1e-8, 0.3))
    relax = clip(8.0 * (a_eq - z[..., 2]), -40.0, 40.0)
    w2 = w[..., 1:]
    rate3 = w2 * iv(lag) + (1.0 - w2) * relax[..., 1:]
    r3 = (z[..., 1:, 2] - z[..., :-1, 2]) / ds - rate3

    # 4) e^N envelope amplification over the system's own profile,
    # saturating softly at n ~ n_crit + 2.5; inert in the wake.
    if wake:
        r4 = z[..., 1:, 3] - z[..., :-1, 3]
    else:
        rate_n = cl.amplification_rate(hk, theta, ret)
        gain = iv(rate_n * _n_sat_gate(z[..., 3], n_crit)) * ds
        r4 = 3.0 * (z[..., 1:, 3] - z[..., :-1, 3] - gain) / (1.0 + gain)

    # Scale to O(1): thickness equations by ds/theta, the lag ODE by ds.
    sc = ds / maximum(t_m, 1e-10)
    return nm.stack([r1 * sc, r2 * sc, r3 * ds, r4], dim=-1)


def _pack(zu, zl, zw):
    batch = zu.shape[:-2]
    return torch.cat([zu.reshape(*batch, -1), zl.reshape(*batch, -1),
                      zw.reshape(*batch, -1)], -1)


def _unpack(zz, m_s: int, n_w: int):
    v = _N_VARS
    batch = nm.value(zz).shape[:-1]
    zu = zz[..., : v * m_s].reshape(*batch, m_s, v)
    zl = zz[..., v * m_s: 2 * v * m_s].reshape(*batch, m_s, v)
    zw = zz[..., 2 * v * m_s:].reshape(*batch, n_w, v)
    return zu, zl, zw


def _w_station(n, x, n_crit, x_trip):
    """Per-station turbulence blend weight: smooth OR of the free
    transition sigmoid (sharp below n_crit, smooth above) and the
    forced-trip chordwise ramp; local to its station."""
    dn = clip(n, -5.0, 30.0) - n_crit
    wn = torch.where(nm.value(dn) < 0.0, 0.25 * _W_N, _W_N)
    wa = nm.sigmoid(dn / wn)
    wt = nm.sigmoid((x - x_trip) / _TR_WIDTH)
    return wa + wt - wa * wt


def _soft_floor(x, lo, beta=60.0):
    """Smooth max(x, lo), with d/dx > 0 everywhere."""
    return lo + nm.softplus(beta * (x - lo)) / beta


def _ue_raws_from_m(op, wop, grid, vt0, m_u, m_l, m_w):
    """Pre-floor station edge velocities, linear in the mass defects
    (modulo the rarely active source clip); ``m_*`` may carry leading batch
    axes or be ``Dual``s. With lanes the grid, ``vt0`` and the wake
    operator are one a lane and ``op`` shared or one a lane."""
    pan = op.pan
    sigma_b = _sigma_nodal_from_sides(
        pan, grid.s0, grid.xi_u, m_u, grid.xi_l, m_l)
    m_te = m_u[..., -1] + m_l[..., -1] + grid.te_gap
    sigma_w = _sigma_wake_nodal(wop.wpan, wop.xi, m_w, m_te)
    vt = (vt0 + nm.matvec(op.due_dsigma, sigma_b)
          + nm.matvec(wop.dvt_dsigw, sigma_w))
    s_mid = 0.5 * (pan.s[..., :-1] + pan.s[..., 1:])
    s_in = s_mid[..., 1:-1]
    vt_in = vt[..., 1:-1]
    raw_u = -nm.interp(grid.s_q_u, s_in, vt_in)
    raw_l = nm.interp(grid.s_q_l, s_in, vt_in)
    raw_w = (wop.uw0 + nm.matvec(wop.wb, sigma_b)
             + nm.matvec(wop.ww, sigma_w))
    # Wake edge velocity continuous with the TE boundary-layer one (linear).
    raw_w = blend_te_continuity(
        wop.xi, raw_w, (0.5 * (raw_u[..., -1] + raw_l[..., -1]))[..., None])
    return raw_u, raw_l, raw_w, vt, sigma_b, sigma_w


def _ue_from_m(op, wop, grid, vt0, m_u, m_l, m_w):
    """Interaction law: station edge velocities from the mass defects."""
    raw_u, raw_l, raw_w, vt, sigma_b, sigma_w = _ue_raws_from_m(
        op, wop, grid, vt0, m_u, m_l, m_w)
    ue_u = _soft_floor(raw_u, _UE_FLOOR_BODY)
    ue_l = _soft_floor(raw_l, _UE_FLOOR_BODY)
    ue_w = _soft_floor(raw_w, _UE_FLOOR_WAKE)
    return ue_u, ue_l, ue_w, vt, sigma_b, sigma_w


def _residual_given_ue(zz, ue_u, ue_l, ue_w, grid, nu, m_s, n_w,
                       n_crit, x_trip_u, x_trip_l):
    """System residual with the edge velocities as explicit arguments:
    every row depends on the one or two stations of its own strip. ``nu``,
    ``n_crit`` and the trips are one a lane (*L)."""
    zu, zl, zw = _unpack(zz, m_s, n_w)
    batch = nm.value(zz).shape[:-1]
    nu_c, nc_c = nu[..., None], n_crit[..., None]

    w_u = _w_station(zu[..., 3], grid.xt_u, nc_c, x_trip_u[..., None])
    w_l = _w_station(zl[..., 3], grid.xt_l, nc_c, x_trip_l[..., None])

    ones_w = torch.ones_like(grid.xi_w)
    ru = _interval_residuals(grid.xi_u, ue_u, zu, nu_c, w_u, False, nc_c)
    rl = _interval_residuals(grid.xi_l, ue_l, zl, nu_c, w_l, False, nc_c)
    rw = _interval_residuals(grid.xi_w, ue_w, zw, nu_c, ones_w, True)

    # Initial conditions: Falkner-Skan stagnation similarity at station 0
    # of each surface, the laminar ctau pin and zero amplification.
    def side_ic(z0, xi0, ue0):
        k = maximum(ue0 / maximum(xi0, 1e-8), 1e-6)
        ln_t0 = 0.5 * nm.log(0.075 * nu / k)
        theta0 = nm.exp(z0[..., 0])
        hk0 = nm.exp(z0[..., 1]) / maximum(ue0, 0.02) / theta0
        ret0 = maximum(ue0 * theta0 / nu, 1.0)
        hk_eq = clip(hk0, 1.005, 1.55)
        hs0 = cl.turb_hstar(hk_eq, ret0)
        cteq0 = cl.turb_cteq(hk_eq, ret0, hs0)
        return nm.stack([
            z0[..., 0] - ln_t0,
            hk0 - 2.24,
            z0[..., 2] - nm.log(clip(0.7 * cteq0, 1e-8, 0.3)),
            z0[..., 3],
        ])

    ric_u = side_ic(zu[..., 0, :], grid.xi_u[..., 0], ue_u[..., 0])
    ric_l = side_ic(zl[..., 0, :], grid.xi_l[..., 0], ue_l[..., 0])

    # Wake initial conditions: thicknesses merge at the trailing edge; the
    # shear coefficient carries over theta-weighted.
    t_te_u = nm.exp(zu[..., -1, 0])
    t_te_l = nm.exp(zl[..., -1, 0])
    d_te_u = nm.exp(zu[..., -1, 1]) / ue_u[..., -1]
    d_te_l = nm.exp(zl[..., -1, 1]) / ue_l[..., -1]
    ct_u = nm.exp(clip(zu[..., -1, 2], -20.0, 0.0))
    ct_l = nm.exp(clip(zl[..., -1, 2], -20.0, 0.0))
    t_w0 = nm.exp(zw[..., 0, 0])
    d_w0 = nm.exp(zw[..., 0, 1]) / ue_w[..., 0]
    ct_mix = ((ct_u * t_te_u + ct_l * t_te_l)
              / maximum(t_te_u + t_te_l, 1e-10))
    ric_w = nm.stack([
        (t_w0 - (t_te_u + t_te_l)) / maximum(t_te_u + t_te_l, 1e-10),
        (d_w0 - (d_te_u + d_te_l + grid.te_gap))
        / maximum(d_te_u + d_te_l + grid.te_gap, 1e-10),
        zw[..., 0, 2] - nm.log(clip(ct_mix, 1e-8, 0.3)),
        zw[..., 0, 3],
    ])

    def flat(r):
        return r.reshape(*batch, -1)

    return nm.cat([ric_u, flat(ru), ric_l, flat(rl), ric_w, flat(rw)])


def _residual(zz, op, wop, grid, vt0, nu, m_s, n_w, n_crit,
              x_trip_u, x_trip_l):
    """Full system residual, (..., _N_VARS * (2 m_s + n_w))."""
    zu, zl, zw = _unpack(zz, m_s, n_w)
    ue_u, ue_l, ue_w, _vt, _sb, _sw = _ue_from_m(
        op, wop, grid, vt0, nm.exp(zu[..., 1]), nm.exp(zl[..., 1]),
        nm.exp(zw[..., 1]))
    return _residual_given_ue(zz, ue_u, ue_l, ue_w, grid, nu,
                              m_s, n_w, n_crit, x_trip_u, x_trip_l)


def _seed_plan(m_s: int, n_w: int):
    """Static colouring/scatter plan for the structured Jacobian (a copy
    of the reference's).

    Colouring by (strip, station parity[, variable]) is collision-free:
    every residual row touches at most one station of each parity within
    its own strip, and the wake-IC rows touch one station of each strip.
    2*3*_N_VARS z-seeds + 6 ue-seeds replace _N_VARS*(2*m_s + n_w) dense
    jacfwd columns.
    """
    v = _N_VARS
    n3 = v * (2 * m_s + n_w)
    s_m = 2 * m_s + n_w

    def zcol(strip, st, var):
        return (0, v * m_s, 2 * v * m_s)[strip] + v * st + var

    def ucol(strip, st):
        return (0, m_s, 2 * m_s)[strip] + st

    def zseed(strip, st, var):
        return strip * 2 * v + (st % 2) * v + var

    def useed(strip, st):
        return strip * 2 + (st % 2)

    r_ru = v
    r_ic_l = r_ru + v * (m_s - 1)
    r_rl = r_ic_l + v
    r_ic_w = r_rl + v * (m_s - 1)
    r_rw = r_ic_w + v

    dep_z, dep_u = [], []
    for strip, base in ((0, 0), (1, r_ic_l)):          # side IC blocks
        for eq in range(v):
            row = base + eq
            for var in range(v):
                dep_z.append((row, strip, 0, var))
            dep_u.append((row, strip, 0))
    for strip, base, m in ((0, r_ru, m_s), (1, r_rl, m_s),
                           (2, r_rw, n_w)):            # interval blocks
        for i in range(1, m):
            for eq in range(v):
                row = base + v * (i - 1) + eq
                for st in (i - 1, i):
                    for var in range(v):
                        dep_z.append((row, strip, st, var))
                    dep_u.append((row, strip, st))
    for eq in range(v):                                # wake IC block
        row = r_ic_w + eq
        for strip, st in ((0, m_s - 1), (1, m_s - 1), (2, 0)):
            for var in range(v):
                dep_z.append((row, strip, st, var))
            dep_u.append((row, strip, st))

    rows_z = np.array([d[0] for d in dep_z], np.int32)
    cols_z = np.array([zcol(*d[1:]) for d in dep_z], np.int32)
    seeds_z = np.array([zseed(*d[1:]) for d in dep_z], np.int32)
    rows_u = np.array([d[0] for d in dep_u], np.int32)
    cols_u = np.array([ucol(*d[1:]) for d in dep_u], np.int32)
    seeds_u = np.array([useed(*d[1:]) for d in dep_u], np.int32)

    bz = np.zeros((n3, 6 * v), np.float32)
    for strip, m in ((0, m_s), (1, m_s), (2, n_w)):
        for st in range(m):
            for var in range(v):
                bz[zcol(strip, st, var), zseed(strip, st, var)] = 1.0
    bu = np.zeros((s_m, 6), np.float32)
    for strip, m in ((0, m_s), (1, m_s), (2, n_w)):
        for st in range(m):
            bu[ucol(strip, st), useed(strip, st)] = 1.0

    # Column index (z-space) of each station's ln-m variable, in m-vector
    # order: the chain-rule scatter for d ue / d z.
    var1_cols = np.array(
        [zcol(0, st, 1) for st in range(m_s)]
        + [zcol(1, st, 1) for st in range(m_s)]
        + [zcol(2, st, 1) for st in range(n_w)], np.int32)

    return dict(rows_z=rows_z, cols_z=cols_z, seeds_z=seeds_z,
                rows_u=rows_u, cols_u=cols_u, seeds_u=seeds_u,
                bz=bz, bu=bu, var1_cols=var1_cols, n3=n3, s_m=s_m)


class _Plan(NamedTuple):
    """``_seed_plan`` on a device: the seeds as ``Dual`` tangents (K, n),
    the scatter indices as int64."""

    bz_t: torch.Tensor          # (24, n3)
    bu_t: torch.Tensor          # (6, s_m)
    rows_z: torch.Tensor
    cols_z: torch.Tensor
    seeds_z: torch.Tensor
    rows_u: torch.Tensor
    cols_u: torch.Tensor
    seeds_u: torch.Tensor
    var1_cols: torch.Tensor
    floors: torch.Tensor        # (s_m,) soft floor of each station's ue
    lam_factors: torch.Tensor   # (4,)
    step_clip: torch.Tensor     # (n3,)


_PLANS: dict = {}   # (m_s, n_w, device) -> _Plan


def _plan_on(m_s: int, n_w: int, dev: torch.device) -> _Plan:
    key = (m_s, n_w, dev)
    plan = _PLANS.get(key)
    if plan is None:
        p = _seed_plan(m_s, n_w)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        plan = _PLANS.setdefault(key, _Plan(
            bz_t=t(p["bz"].T, DTYPE), bu_t=t(p["bu"].T, DTYPE),
            **{k: t(p[k]) for k in ("rows_z", "cols_z", "seeds_z", "rows_u",
                                    "cols_u", "seeds_u", "var1_cols")},
            floors=t([_UE_FLOOR_BODY] * (2 * m_s) + [_UE_FLOOR_WAKE] * n_w,
                     DTYPE),
            lam_factors=t(_LAM_FACTORS, DTYPE),
            step_clip=t(_STEP_CLIP * (2 * m_s + n_w), DTYPE)))
    return plan


def _lane_vals(v, p: int, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a number, a 0-d or (P,) tensor, or a sequence of P numbers)
    as a (P,) float32 tensor on ``like``'s device; a number is filled in on
    the device, not copied there (a copy from the host would synchronise
    the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=DTYPE).expand(p)
    a = np.asarray(v, np.float32)
    if a.ndim == 0:
        return torch.full((p,), float(a), dtype=DTYPE, device=like.device)
    return torch.as_tensor(a, device=like.device).expand(p)


def _rms(r):
    """Root mean square over the last axis, a non-finite entry as 1e6."""
    r = torch.where(torch.isfinite(r), r, 1e6)
    return torch.sqrt(torch.mean(r * r, -1))


def _seeded(b: torch.Tensor, lanes) -> torch.Tensor:
    """Seed tangents (K, n) for every lane: (K, *lanes, n)."""
    k, n = b.shape
    return b.reshape(k, *[1] * len(lanes), n).expand(k, *lanes, n)


class _System:
    """The Newton system of one operating point, or of P points side by
    side (every tensor with a leading lane axis: the grid, ``vt0`` and the
    wake operator one a lane, ``nu``, ``n_crit`` and the trips (P,), the
    states (P, n3)); ``op`` is shared by the lanes or stacked one a lane.
    Residual, structured Jacobian, one LM iteration, the amplification
    re-projection; every method works on the device without reading it
    back."""

    def __init__(self, op, wop, grid, vt0, nu, m_s, n_w, n_crit,
                 x_trip_u, x_trip_l, zz_lin=None, l_mat=None):
        self.op, self.wop, self.grid, self.vt0, self.nu = op, wop, grid, vt0, nu
        self.m_s, self.n_w = m_s, n_w
        self.n_crit, self.x_trip_u, self.x_trip_l = n_crit, x_trip_u, x_trip_l
        self.lanes = tuple(vt0.shape[:-1])
        self.shared = isinstance(op, InviscidOperator)
        self.plan = _plan_on(m_s, n_w, vt0.device)
        if l_mat is not None or zz_lin is None:
            # Given, or not needed: only an LM iteration reads it.
            self.l_mat = l_mat
            return
        # The interaction operator's Jacobian at the state the LM starts
        # from (for a continuation, the donor's), exact modulo the rarely
        # active derivative clip: one evaluation on a Dual over the
        # 2 m_s + n_w station mass defects.
        zu, zl, zw = _unpack(zz_lin, m_s, n_w)
        m_lin = torch.cat([torch.exp(zu[..., 1]), torch.exp(zl[..., 1]),
                           torch.exp(zw[..., 1])], -1)
        eye = torch.eye(m_lin.shape[-1], dtype=m_lin.dtype,
                        device=m_lin.device)
        self.l_mat = self.raws_of_m(nm.Dual(m_lin, _seeded(eye, self.lanes))
                                    ).t.movedim(0, -1).contiguous()

    def raws_of_m(self, m_all):
        m_s = self.m_s
        r_u, r_l, r_w, _vt, _sb, _sw = _ue_raws_from_m(
            self.op, self.wop, self.grid, self.vt0, m_all[..., :m_s],
            m_all[..., m_s:2 * m_s], m_all[..., 2 * m_s:])
        return nm.cat([r_u, r_l, r_w])

    def residual(self, zz):
        return _residual(zz, self.op, self.wop, self.grid, self.vt0,
                         self.nu, self.m_s, self.n_w, self.n_crit,
                         self.x_trip_u, self.x_trip_l)

    def _given_ue(self, zz, ue_u, ue_l, ue_w):
        return _residual_given_ue(zz, ue_u, ue_l, ue_w, self.grid, self.nu,
                                  self.m_s, self.n_w, self.n_crit,
                                  self.x_trip_u, self.x_trip_l)

    def jacobian(self, zz):
        """J = scatter(banded dR/dz) + scatter(banded dR/due) diag(softfloor')
        L diag(m): 24 + 6 coloured tangents instead of a dense jacfwd;
        (*L, n3, n3)."""
        m_s, plan, lanes = self.m_s, self.plan, self.lanes
        zu, zl, zw = _unpack(zz, m_s, self.n_w)
        m_all = torch.cat([torch.exp(zu[..., 1]), torch.exp(zl[..., 1]),
                           torch.exp(zw[..., 1])], -1)
        raws = self.raws_of_m(m_all)
        ues = _soft_floor(raws, plan.floors)
        ue_u, ue_l, ue_w = (ues[..., :m_s], ues[..., m_s:2 * m_s],
                            ues[..., 2 * m_s:])

        jbz = self._given_ue(nm.Dual(zz, _seeded(plan.bz_t, lanes)),
                             ue_u, ue_l, ue_w).t.movedim(0, -1)
        bu = plan.bu_t
        jbu = self._given_ue(
            zz, nm.Dual(ue_u, _seeded(bu[:, :m_s], lanes)),
            nm.Dual(ue_l, _seeded(bu[:, m_s:2 * m_s], lanes)),
            nm.Dual(ue_w, _seeded(bu[:, 2 * m_s:], lanes))).t.movedim(0, -1)

        n3 = zz.shape[-1]
        jac = zz.new_zeros((*lanes, n3, n3))
        jac[..., plan.rows_z, plan.cols_z] = jbz[..., plan.rows_z,
                                                 plan.seeds_z]
        ju = zz.new_zeros((*lanes, n3, m_all.shape[-1]))
        ju[..., plan.rows_u, plan.cols_u] = jbu[..., plan.rows_u,
                                                plan.seeds_u]

        sfp = nm.sigmoid(_SF_BETA * (raws - plan.floors))
        j_via_ue = (ju * sfp[..., None, :]) @ self.l_mat
        jac[..., plan.var1_cols] += j_via_ue * m_all[..., None, :]
        return jac

    def normal_equations(self, zz):
        """(rms of the residual, J^T J, J^T r) at ``zz``."""
        r = self.residual(zz)
        jt = self.jacobian(zz).mT
        return _rms(r), jt @ jt.mT, (jt @ r[..., None])[..., 0]

    def candidate_steps(self, jtj, jtr, lam):
        """The four damped steps, (4, *L, n3): (J^T J + lam f D) dz = -J^T r
        by a batched Cholesky and two triangular solves; clipped per
        variable type, and 0 where a step is not finite (a failed factor is
        NaN)."""
        plan = self.plan
        diag = maximum(torch.diagonal(jtj, dim1=-2, dim2=-1), 1e-8)
        factors = plan.lam_factors.reshape(4, *[1] * lam.dim())
        a = jtj + torch.diag_embed((lam[None] * factors)[..., None]
                                   * diag[None])
        # JAX's Cholesky reads the symmetrised matrix.
        chol, info = torch.linalg.cholesky_ex((a + a.mT) / 2.0)
        chol = torch.where((info != 0)[..., None, None], torch.nan, chol)
        rhs = (-jtr)[None, ..., None].expand(*chol.shape[:-1], 1)
        y = torch.linalg.solve_triangular(chol, rhs, upper=False)
        dz = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
        dz = clip(dz, -plan.step_clip, plan.step_clip)
        return torch.where(torch.isfinite(dz).all(-1, keepdim=True), dz, 0.0)

    def lm_step(self, zz, lam):
        """One Levenberg-Marquardt iteration: (zz, lam) -> (zz, lam), every
        lane its own choice of candidate."""
        rms_here, jtj, jtr = self.normal_equations(zz)
        dzs = self.candidate_steps(jtj, jtr, lam)
        rmss = _rms(self.residual(zz[None] + dzs))
        # Near-tie rule: among candidates within 1% of the best rms, the
        # gentlest damping (the first hit).
        near = rmss <= torch.amin(rmss, 0) * 1.01
        best = near.to(torch.int32).argmax(0)
        accept = rmss.gather(0, best[None])[0] < rms_here
        step = torch.take_along_dim(dzs, best[None, ..., None], 0)[0]
        zz = torch.where(accept[..., None], zz + step, zz)
        factor = self.plan.lam_factors.index_select(
            0, best.reshape(-1)).reshape(best.shape)
        lam = clip(torch.where(accept, lam * factor / 3.0, lam * 64.0),
                   1e-7, 1e6)
        return zz, lam

    def lm_tensors(self) -> "_LMTensors":
        """Every tensor ``lm_step`` reads but the plan's constants, each
        dense (a graph's static copy of it then has its layout)."""
        op, wop, g = self.op, self.wop, self.grid
        return _LMTensors(*(a.contiguous() for a in (
            op.pan.s, op.due_dsigma, wop.wpan.s, wop.xi, wop.dvt_dsigw,
            wop.uw0, wop.wb, wop.ww, g.xi_u, g.xi_l, g.xi_w, g.s_q_u,
            g.s_q_l, g.s0, g.te_gap, g.xt_u, g.xt_l, self.vt0, self.nu,
            self.n_crit, self.x_trip_u, self.x_trip_l, self.l_mat)))

    @classmethod
    def of_lm_tensors(cls, t: "_LMTensors", m_s: int, n_w: int) -> "_System":
        """The system that holds ``t`` and nothing else: every other field
        of its operators and grid is None, so ``lm_step`` on it can read no
        tensor that is not in ``t``."""
        op = _LaneOps(_s_only(t.pan_s), t.due_dsigma)
        wop = WakeOperator(_s_only(t.wpan_s), t.w_xi, t.dvt_dsigw, t.uw0,
                           t.wb, t.ww)
        grid = _Grid(xi_u=t.xi_u, xi_l=t.xi_l, xi_w=t.xi_w, x_u=None,
                     y_u=None, x_l=None, y_l=None, s_q_u=t.s_q_u,
                     s_q_l=t.s_q_l, s0=t.s0, te_gap=t.te_gap, xt_u=t.xt_u,
                     xt_l=t.xt_l)
        return cls(op, wop, grid, t.vt0, t.nu, m_s, n_w, t.n_crit,
                   t.x_trip_u, t.x_trip_l, l_mat=t.l_mat)

    def run_lm(self, zz, lam, iters: int):
        """``iters`` LM iterations from (zz, lam): on the card by replaying
        this system's shape key's graph of one iteration, on the CPU by
        calling the same body eagerly (``viscous.graphs.run_lm``)."""
        return graphs.run_lm(
            lm_key(self), functools.partial(_lm_body, self.m_s, self.n_w),
            [zz, lam, *self.lm_tensors()], iters)

    def reproject_n(self, zz):
        """Exact re-integration of the amplification ODE over the iterate's
        own profile, both sides (and every lane) as lanes of one station
        loop (the reference's scan per side); removes the n-rows' slow
        drift."""
        grid, nu = self.grid, self.nu
        zu, zl, zw = _unpack(zz, self.m_s, self.n_w)
        ue_u, ue_l, _uw, _vt, _sb, _sw = _ue_from_m(
            self.op, self.wop, grid, self.vt0, torch.exp(zu[..., 1]),
            torch.exp(zl[..., 1]), torch.exp(zw[..., 1]))
        z2 = torch.stack([zu, zl])
        ue = torch.stack([ue_u, ue_l])
        theta = maximum(torch.exp(z2[..., 0]), 1e-10)
        dstar = torch.exp(z2[..., 1]) / maximum(ue, 0.02)
        hk = clip(dstar / theta, 1.005, 12.0)
        ret = maximum(ue * theta / nu[..., None], 1.0)
        rate = cl.amplification_rate(hk, theta, ret)
        avg = _avg(rate[..., :-1], rate[..., 1:])
        dxi = maximum(torch.diff(torch.stack([grid.xi_u, grid.xi_l])), 1e-8)
        n = torch.zeros_like(ue[..., 0])
        cols = [n]
        n_hi = self.n_crit + 3.0
        for k in range(self.m_s - 1):
            n = n + avg[..., k] * _n_sat_gate(n, self.n_crit) * dxi[..., k]
            n = clip(n, 0.0, n_hi)
            cols.append(n)
        z2 = z2.clone()
        z2[..., 3] = torch.stack(cols, -1)
        zw = zw.clone()
        zw[..., 3] = 0.0
        return _pack(z2[0], z2[1], zw)


def lm_key(system: _System) -> tuple:
    """The shape key of a system's graphs (``viscous.graphs``): (device,
    lanes, stations a side, wake stations, operator shared by the lanes,
    panel nodes)."""
    return (system.vt0.device, system.lanes, system.m_s, system.n_w,
            system.shared, system.op.pan.s.shape[-1])


class _LMTensors(NamedTuple):
    """What one LM iteration reads besides the plan's constants (which are
    cached per shape and device and never freed): the flat inputs of its
    CUDA graph after the state and the damping."""

    pan_s: torch.Tensor         # the body's node arcs, (N+1,) or (P, N+1)
    due_dsigma: torch.Tensor    # (N, N) shared or (P, N, N) one a lane
    wpan_s: torch.Tensor        # the wake line's node arcs (P, Mw+1)
    w_xi: torch.Tensor          # the wake operator's stations (P, Mw)
    dvt_dsigw: torch.Tensor
    uw0: torch.Tensor
    wb: torch.Tensor
    ww: torch.Tensor
    xi_u: torch.Tensor          # the grid's fields but the station x, y
    xi_l: torch.Tensor
    xi_w: torch.Tensor
    s_q_u: torch.Tensor
    s_q_l: torch.Tensor
    s0: torch.Tensor
    te_gap: torch.Tensor
    xt_u: torch.Tensor
    xt_l: torch.Tensor
    vt0: torch.Tensor
    nu: torch.Tensor
    n_crit: torch.Tensor
    x_trip_u: torch.Tensor
    x_trip_l: torch.Tensor
    l_mat: torch.Tensor


def _s_only(s: torch.Tensor) -> Paneling:
    """A paneling that holds its node arcs alone: all that an LM iteration
    reads of one."""
    return Paneling(*(None,) * (len(Paneling._fields) - 1), s=s)


def _lm_body(m_s: int, n_w: int, flat):
    """One LM iteration as a plain function of the flat list ``[zz, lam,
    *_LMTensors]``: (zz, lam) -> (zz, lam) of ``_System.lm_step``. What a
    CUDA graph captures, and what the round runs eagerly on the CPU."""
    zz, lam, *rest = flat
    return _System.of_lm_tensors(_LMTensors(*rest), m_s, n_w).lm_step(zz, lam)


def _warm_start(op, wop, grid, vt0, nu, n_crit, trip_u, trip_l, m_s, n_w,
                warm_iters: int):
    """Direct under-relaxed iterations that produce the Newton initial
    state (``coupled.solve_viscous``'s loop, keeping the march arrays),
    every lane at once: ``warm_iters`` + 1 side marches of 2P lanes (the
    upper sides, then the lower ones)."""
    pan = op.pan
    p = vt0.shape[0]
    sides = (torch.cat([grid.xi_u, grid.xi_l]),
             torch.cat([grid.x_u, grid.x_l]))
    nu2, nc2 = torch.cat([nu, nu]), torch.cat([n_crit, n_crit])
    trips = torch.cat([trip_u, trip_l])
    s_in = (0.5 * (pan.s[..., :-1] + pan.s[..., 1:]))[..., 1:-1]

    def one(sigma_b, sigma_w):
        vt = (vt0 + nm.matvec(op.due_dsigma, sigma_b)
              + nm.matvec(wop.dvt_dsigw, sigma_w))
        ue_u = maximum(-nm.interp(grid.s_q_u, s_in, vt[..., 1:-1]), 0.02)
        ue_l = maximum(nm.interp(grid.s_q_l, s_in, vt[..., 1:-1]), 0.02)
        bl2 = kernel.march_side(sides[0], torch.cat([ue_u, ue_l]), sides[1],
                                nu2, nc2, trips)
        ue_w = (wop.uw0 + nm.matvec(wop.wb, sigma_b)
                + nm.matvec(wop.ww, sigma_w))
        ue_w = maximum(blend_te_continuity(
            wop.xi, ue_w, 0.5 * (ue_u[..., -1:] + ue_l[..., -1:])), 0.05)
        return (_lanes_of(bl2, slice(0, p)), _lanes_of(bl2, slice(p, None)),
                ue_u, ue_l, ue_w)

    def wake_shape(bl_u, bl_l):
        th0 = bl_u.theta[..., -1] + bl_l.theta[..., -1]
        ds0 = bl_u.dstar[..., -1] + bl_l.dstar[..., -1] + grid.te_gap
        hk_w = 1.0 + (ds0 / maximum(th0, 1e-10) - 1.0)[..., None] * torch.exp(
            -grid.xi_w / 0.35)
        return th0[..., None], hk_w

    sigma_b = vt0.new_zeros((p, pan.xm.shape[-1]))
    sigma_w = vt0.new_zeros((p, n_w))
    drel = None
    for _ in range(warm_iters):
        bl_u, bl_l, ue_u, ue_l, ue_w = one(sigma_b, sigma_w)
        sb = _sigma_from_sides(pan, grid.s0, grid.xi_u, ue_u * bl_u.dstar,
                               grid.xi_l, ue_l * bl_l.dstar)
        th0, hk_w = wake_shape(bl_u, bl_l)
        sw = _smooth_clip_derivative(wop.xi, ue_w * (hk_w * th0))
        sb = torch.where(torch.isfinite(sb), sb, sigma_b)
        sw = torch.where(torch.isfinite(sw), sw, sigma_w)
        # Relative fixed-point residual: gates the warm trajectory's use as
        # a fallback result.
        drel = (torch.mean(torch.abs(sb - sigma_b), -1)
                / maximum(torch.mean(torch.abs(sb), -1), 1e-8))
        sigma_b = sigma_b + 0.35 * (sb - sigma_b)
        sigma_w = sigma_w + 0.35 * (sw - sigma_w)
    warm_settled = drel < 0.10

    bl_u, bl_l, ue_u, ue_l, ue_w = one(sigma_b, sigma_w)

    def side_init(bl, ue):
        theta = maximum(bl.theta, 1e-9)
        m = maximum(ue * bl.dstar, 1e-9)
        ct = torch.where(torch.isnan(bl.ctau), 1e-4, bl.ctau)
        # n from the march's amplification; a turbulent station starts just
        # past the crossing.
        n = torch.where(torch.isnan(bl.amp), n_crit[:, None] + 1.5,
                        clip(bl.amp, 0.0, n_crit[:, None] + 3.0))
        return torch.stack([torch.log(theta), torch.log(m),
                            torch.log(clip(ct, 1e-8, 0.3)), n], dim=-1)

    zu = side_init(bl_u, ue_u)
    zl = side_init(bl_l, ue_l)

    th0, hk_w = wake_shape(bl_u, bl_l)
    t_w = torch.full_like(grid.xi_w, 1.0) * th0
    m_wk = maximum(ue_w * hk_w * th0, 1e-9)
    ct_w = torch.full_like(grid.xi_w, 2e-3)
    zw = torch.stack([torch.log(maximum(t_w, 1e-9)), torch.log(m_wk),
                      torch.log(ct_w), torch.zeros_like(t_w)], dim=-1)

    def march_front(bl, x):
        # The march's own transition; its 'none' sentinel (the TE x) -> 2.
        return torch.where(bl.x_transition < x[..., -1] - 1e-6,
                           bl.x_transition, 2.0)

    warm_state = dict(sigma_b=sigma_b, sigma_w=sigma_w, bl_u=bl_u,
                      bl_l=bl_l, ue_u=ue_u, ue_l=ue_l, ue_w=ue_w,
                      settled=warm_settled)
    return (_pack(zu, zl, zw), march_front(bl_u, grid.x_u),
            march_front(bl_l, grid.x_l), warm_state)


def _lanes_of(bl: BLState, idx) -> BLState:
    return BLState(*(a[idx] for a in bl))


def _friction_drag(cf, ue, x):
    integrand = cf * ue ** 2
    return torch.sum(0.5 * (integrand[..., 1:] + integrand[..., :-1])
                     * torch.abs(torch.diff(x)), -1)


def _fallback_scalars(op, wop, grid, vt0, ws, alpha_deg, nu, dtype,
                      cl_inv=None):
    """Polar-point scalars from the warm-start direct trajectory (wake
    march + Squire-Young + Cp forces), for points where Newton flags a
    wrong basin, one a lane: (cl, cd, cdp, cm, ok, xtr_u, xtr_l,
    sep_fraction). One wake march of P lanes."""
    bl_u, bl_l = ws["bl_u"], ws["bl_l"]
    ue_u, ue_l, ue_w = ws["ue_u"], ws["ue_l"], ws["ue_w"]
    sigma_b, sigma_w = ws["sigma_b"], ws["sigma_w"]

    vt = (vt0 + nm.matvec(op.due_dsigma, sigma_b)
          + nm.matvec(wop.dvt_dsigw, sigma_w))
    cp = 1.0 - vt * vt
    cl_c, cm, _cdp_raw = _forces_from_cp(op.pan, cp, alpha_deg)

    th0 = bl_u.theta[..., -1] + bl_l.theta[..., -1]
    ds0 = bl_u.dstar[..., -1] + bl_l.dstar[..., -1] + grid.te_gap

    ct0 = wake_ctau0(bl_u, bl_l, th0, ds0,
                     0.5 * (ue_u[..., -1] + ue_l[..., -1]), nu)
    th_w, _ds_w, hk_w = kernel.march_wake(wop.xi, ue_w, nu, th0, ds0, ct0)

    h_end = clip(hk_w[..., -1], 1.0, 2.5)
    ue_end = clip(ue_w[..., -1], 0.2, 1.5)
    cd = 2.0 * th_w[..., -1] * ue_end ** (0.5 * (h_end + 5.0))

    cdf = (_friction_drag(bl_u.cf, ue_u, grid.x_u)
           + _friction_drag(bl_l.cf, ue_l, grid.x_l))
    cdp = cd - cdf

    sep = 0.5 * (torch.mean(bl_u.separated.to(dtype), -1)
                 + torch.mean(bl_l.separated.to(dtype), -1))
    finite = (torch.isfinite(cl_c) & torch.isfinite(cd)
              & torch.isfinite(sigma_b).all(-1))
    cd_lo = 1.0 / torch.sqrt(1.0 / nu)
    cd_hi = 0.25 * (1.0 / nu) ** -0.2
    ok = (finite & (sep < 0.25) & (cd > cd_lo) & (cd < cd_hi)
          & ws["settled"])
    if cl_inv is not None:
        # Viscosity only ever reduces the circulation magnitude.
        ok = ok & (torch.abs(cl_c) < 1.05 * torch.abs(cl_inv) + 0.03)
    return (cl_c, cd, cdp, cm, ok,
            clip(bl_u.x_transition, 0.0, 1.0),
            clip(bl_l.x_transition, 0.0, 1.0), sep)


def state_from_numpy(zz, xtr_u, xtr_l, device=None):
    """A donor state (zz, x_tr upper, x_tr lower) of the reference's
    ``solve_polar_point``, as numpy, on the port's device (see
    ``resolve_device``): what a continuation solve starts from. With a
    leading lane axis, one donor a lane."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in (zz, xtr_u, xtr_l))


def _trip_coord(x):
    """x masked to -1 before the leading edge (the strip wraps round it)."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(idx >= torch.argmin(x), x, -1.0)


def _point_grid(op: InviscidOperator, alpha, n_stations: int, n_wake: int):
    """The inviscid solution at ``alpha`` (a tensor), the wake operator and
    the station grid frozen at the inviscid stagnation point: one point."""
    pan = op.pan
    sol0 = solve_inviscid(op, alpha)
    vt0 = sol0.vt
    wop: WakeOperator = build_wake_operator(op, alpha, n_wake=n_wake)
    te_gap = torch.hypot(pan.xp[0] - pan.xp[-1], pan.yp[0] - pan.yp[-1])
    s_le = _at(pan.s, torch.argmin(pan.xp))
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s0 = _find_stagnation(s_mid, vt0, s_le)
    xi_u, s_q_u, _ue, x_u, y_u = _side_stations(pan, vt0, s0, True,
                                                n_stations)
    xi_l, s_q_l, _ue, x_l, y_l = _side_stations(pan, vt0, s0, False,
                                                n_stations)
    grid = _Grid(xi_u=xi_u, xi_l=xi_l, xi_w=wop.xi, x_u=x_u, y_u=y_u,
                 x_l=x_l, y_l=y_l, s_q_u=s_q_u, s_q_l=s_q_l, s0=s0,
                 te_gap=te_gap, xt_u=_trip_coord(x_u), xt_l=_trip_coord(x_l))
    return sol0, wop, grid


class _LaneOps(NamedTuple):
    """What the lane solve reads of P operators stacked one a lane."""

    pan: Paneling
    due_dsigma: torch.Tensor


def _lane_setup(op, alphas: torch.Tensor, n_stations: int, n_wake: int):
    """Every lane's inviscid solution, wake operator and station grid (a
    host loop over the lanes, its results stacked): (operators one a lane
    or shared, inviscid CL (P,), vt0 (P, N), wake operator, grid)."""
    shared = isinstance(op, InviscidOperator)
    ops = [op] * alphas.shape[0] if shared else list(op)
    if len(ops) != alphas.shape[0]:
        raise ValueError(f"{len(ops)} operators for {alphas.shape[0]} lanes")
    points = [_point_grid(o, alphas[i], n_stations, n_wake)
              for i, o in enumerate(ops)]
    sols, wops, grids = zip(*points)
    lane_op = op if shared else _LaneOps(
        stack_lanes([o.pan for o in ops]),
        torch.stack([o.due_dsigma for o in ops]))
    return (lane_op, torch.stack([s.cl for s in sols]),
            torch.stack([s.vt for s in sols]), stack_lanes(wops),
            stack_lanes(grids))


def _n_lanes(op, alphas) -> int:
    if not isinstance(op, InviscidOperator):
        return len(op)
    if isinstance(alphas, torch.Tensor):
        return max(alphas.numel(), 1)
    return max(int(np.size(alphas)), 1)


class _Prepared(NamedTuple):
    """What ``_prepare``'s device work gives: a program's outputs."""

    lane_op: _LaneOps | None    # the stacked operators (None when shared)
    cl_inv: torch.Tensor        # (P,) inviscid CL
    vt0: torch.Tensor
    wop: WakeOperator
    grid: _Grid
    nu: torch.Tensor
    x_trip_u: torch.Tensor      # the trips tightened to the warm fronts
    x_trip_l: torch.Tensor
    l_mat: torch.Tensor
    zz0: torch.Tensor           # the warm start's state
    warm_state: dict


def _prepare(op, alpha_deg, reynolds, n_crit, x_forced_transition,
             n_stations, n_wake, warm_iters, init_state=None,
             x_trip_lower=None):
    """The lanes' inviscid solutions, station grids, warm start and Newton
    system: (system, scalars, warm state, start state). ``op`` is one
    operator (shared by every lane) or a sequence of P; the other
    arguments are numbers, 0-d tensors or one value a lane; the start
    state ``init_state`` is (zz (P, n3), ...).

    The lane values are made here; the device work (``_prepare_body``) is
    a program of ``viscous.graphs``, keyed as the LM iteration (``lm_key``)
    plus ``warm_iters`` and whether ``init_state`` is given."""
    p = _n_lanes(op, alpha_deg)
    shared = isinstance(op, InviscidOperator)
    ops = op if shared else list(op)
    first = op if shared else ops[0]
    like = first.pan.xm

    def lanes(v):
        return _lane_vals(v, p, like)

    alpha, re, n_crit_t = lanes(alpha_deg), lanes(reynolds), lanes(n_crit)
    x_trip_t = lanes(x_forced_transition)
    x_trip_lo_t = (x_trip_t if x_trip_lower is None
                   else lanes(x_trip_lower))
    zz_init = None if init_state is None else init_state[0].reshape(p, -1)
    flat, spec = graphs.flatten((
        _read_fields(op) if shared else [_read_fields(o) for o in ops], alpha,
        re, n_crit_t, x_trip_t, x_trip_lo_t, zz_init))
    m_s, n_w = n_stations, n_wake
    key = (like.device, (p,), m_s, n_w, shared, first.pan.s.shape[-1],
           warm_iters, zz_init is not None)
    out = graphs.run("prepare", key, functools.partial(
        _prepare_body, spec, m_s, n_w, warm_iters), flat)
    system = _System(op if shared else out.lane_op, out.wop, out.grid,
                     out.vt0, out.nu, m_s, n_w, n_crit_t, out.x_trip_u,
                     out.x_trip_l, l_mat=out.l_mat)
    scalars = dict(alpha=alpha, re=re, nu=out.nu, cl_inv=out.cl_inv,
                   x_trip=x_trip_t, x_trip_lo=x_trip_lo_t)
    zz_i = out.zz0 if zz_init is None else zz_init
    return system, scalars, out.warm_state, zz_i


def _prepare_body(spec, m_s: int, n_w: int, warm_iters: int,
                  flat) -> _Prepared:
    """``_prepare``'s device work as a plain function of the flat list of
    the operators and the lane values (``spec`` their structure): the
    lanes' set-up (its host loop over the lanes included), the warm start,
    the trip ceilings and the interaction operator's Jacobian."""
    op, alpha, re, n_crit_t, x_trip_t, x_trip_lo_t, zz_init = \
        graphs.unflatten(spec, flat)
    nu = 1.0 / re
    lane_op, cl_inv, vt0, wop, grid = _lane_setup(op, alpha, m_s, n_w)

    zz0, xtr_u_march, xtr_l_march, warm_state = _warm_start(
        lane_op, wop, grid, vt0, nu, n_crit_t, x_trip_t, x_trip_lo_t, m_s,
        n_w, warm_iters)

    # Per-side trip ceiling: the user trip, tightened to the warm march's
    # own front plus a slack proportional to it (closes the all-laminar
    # basin; see the reference).
    def ceiling(front):
        return front + 0.15 + 0.6 * front

    x_trip_u_t = minimum(x_trip_t, ceiling(xtr_u_march))
    x_trip_l_t = minimum(x_trip_lo_t, ceiling(xtr_l_march))

    zz_i = zz0 if zz_init is None else zz_init
    system = _System(lane_op, wop, grid, vt0, nu, m_s, n_w, n_crit_t,
                     x_trip_u_t, x_trip_l_t, zz_i)
    return _Prepared(
        None if isinstance(op, InviscidOperator) else lane_op, cl_inv, vt0,
        wop, grid, nu, x_trip_u_t, x_trip_l_t, system.l_mat, zz0,
        warm_state)


def _lm_rounds(system, zz_i, newton_iters: int, outer_rounds: int):
    """Up to ``outer_rounds`` restart rounds of ``newton_iters`` LM
    iterations, the damping floor re-applied between rounds, with the
    semantics of the reference's ``while_loop`` under ``vmap``: every
    active lane runs the same iterations a round; a lane stops once
    settled (rms below the gate) or futile (a round made less than 8%
    relative progress) and keeps its carry frozen from then on; the loop
    ends when no lane is active. The lane mask is the one host read a
    round. A round is three programs of ``viscous.graphs`` keyed by
    ``lm_key``: the re-projection (``_reproject_body``), the LM iterations
    (``system.run_lm``) and the residual with the lanes' bookkeeping
    (``_settle_body``). Returns the best state, its rms and the rounds
    each lane ran, (P, n3), (P,) and (P,)."""
    p = zz_i.shape[0]
    zz, lam = zz_i, _lane_vals(1e-3, p, zz_i)
    best_zz = zz_i
    best_rms = rms_prev = _lane_vals(torch.inf, p, zz_i)
    done = torch.zeros(p, dtype=torch.bool, device=zz_i.device)
    rounds = torch.zeros(p, dtype=torch.int32, device=zz_i.device)
    key = lm_key(system)
    shape = (system.m_s, system.n_w)
    # What each body reads of the system (None for what it does not).
    t_settle = system.lm_tensors()._replace(l_mat=None)
    t_reproject = t_settle._replace(xi_w=None, xt_u=None, xt_l=None,
                                    x_trip_u=None, x_trip_l=None)
    for _ in range(outer_rounds):
        flat, spec = graphs.flatten((zz, lam, done, rounds, t_reproject))
        zz_r, lam_in, rounds = graphs.run(
            "reproject", key,
            functools.partial(_reproject_body, spec, *shape), flat)
        zz_r, lam_r = system.run_lm(zz_r, lam_in, newton_iters)
        flat, spec = graphs.flatten((zz_r, lam_r, zz, lam, best_zz,
                                     best_rms, rms_prev, done, t_settle))
        zz, lam, best_zz, best_rms, rms_prev, done, active = graphs.run(
            "settle", key, functools.partial(_settle_body, spec, *shape),
            flat)
        if not bool(active):
            break
    return best_zz, best_rms, rounds


def _reproject_body(spec, m_s: int, n_w: int, flat):
    """A round's work before its LM iterations, as a plain function of the
    flat list of (zz, lam, done, rounds, the ``_LMTensors`` it reads):
    (the re-projected state, the floored damping, the rounds counted)."""
    zz, lam, done, rounds, t = graphs.unflatten(spec, flat)
    system = _System.of_lm_tensors(t, m_s, n_w)
    rounds = rounds + (~done).to(torch.int32)
    return system.reproject_n(zz), maximum(lam, 1e-4), rounds


def _settle_body(spec, m_s: int, n_w: int, flat):
    """A round's work after its LM iterations, as a plain function of the
    flat list of (zz_r, lam_r, zz, lam, best_zz, best_rms, rms_prev, done,
    the ``_LMTensors`` it reads): the round's residual, the best state
    kept, the active lanes' carry taken, the settled and futile lanes
    stopped; returns the new (zz, lam, best_zz, best_rms, rms_prev, done)
    and whether a lane is still active."""
    zz_r, lam_r, zz, lam, best_zz, best_rms, rms_prev, done, t = \
        graphs.unflatten(spec, flat)
    system = _System.of_lm_tensors(t, m_s, n_w)
    act = ~done
    rms_r = _rms(system.residual(zz_r))
    ok_r = act & (rms_r < best_rms) & torch.isfinite(zz_r).all(-1)
    best_zz = torch.where(ok_r[:, None], zz_r, best_zz)
    best_rms = torch.where(ok_r, rms_r, best_rms)
    done_r = (rms_r < _RMS_OK) | (rms_r > _FUTILITY * rms_prev)
    zz = torch.where(act[:, None], zz_r, zz)
    lam = torch.where(act, lam_r, lam)
    rms_prev = torch.where(act, rms_r, rms_prev)
    done = done | (act & done_r)
    return zz, lam, best_zz, best_rms, rms_prev, done, (~done).any()


def _solve_lanes(op, alpha_deg, reynolds, n_crit, x_forced_transition,
                 n_stations, n_wake, warm_iters, newton_iters, outer_rounds,
                 init_state=None, x_trip_lower=None):
    """The Newton solve of P lanes side by side: (ViscousResult, fallback
    scalars, final state), every field with a leading lane axis."""
    system, sc, warm_state, zz_i = _prepare(
        op, alpha_deg, reynolds, n_crit, x_forced_transition, n_stations,
        n_wake, warm_iters, init_state, x_trip_lower)
    zz, rms, _rounds = _lm_rounds(system, zz_i, newton_iters, outer_rounds)
    return _lane_answer(system, sc, warm_state, zz, rms)


class _AnswerTensors(NamedTuple):
    """What the lanes' answer reads of a system."""

    op: _LaneOps                # the paneling and the body sensitivity
    wop: WakeOperator
    grid: _Grid
    vt0: torch.Tensor
    nu: torch.Tensor
    n_crit: torch.Tensor
    x_trip_u: torch.Tensor
    x_trip_l: torch.Tensor


def _lane_answer(system, sc, warm_state, zz, rms):
    """The lanes' answer at the state ``zz`` (P, n3), whose residual rms is
    ``rms`` (P,): (ViscousResult, fallback scalars, final state). A
    program of ``viscous.graphs`` keyed by ``lm_key`` (``_answer_body``)."""
    pan, wop = system.op.pan, system.wop
    # What the body reads, None for what it does not.
    t = _AnswerTensors(
        _LaneOps(pan._replace(xp=None, yp=None, tx=None, ty=None),
                 system.op.due_dsigma),
        wop._replace(wpan=_s_only(wop.wpan.s)),
        system.grid._replace(xi_w=None), system.vt0, system.nu,
        system.n_crit, system.x_trip_u, system.x_trip_l)
    sc = {k: sc[k] for k in ("alpha", "re", "cl_inv", "x_trip",
                             "x_trip_lo")}
    warm_state = dict(warm_state, **{
        side: warm_state[side]._replace(amp=None, turb=None)
        for side in ("bl_u", "bl_l")})
    flat, spec = graphs.flatten((t, sc, warm_state, zz, rms))
    res, fb, (xtr_u, xtr_l) = graphs.run(
        "answer", lm_key(system), functools.partial(
            _answer_body, spec, system.m_s, system.n_w), flat)
    return res, fb, (zz, xtr_u, xtr_l)


def _answer_body(spec, m_s: int, n_w: int, flat):
    """The lanes' answer as a plain function of the flat list of
    ``_AnswerTensors``, the lane values, the warm state, the state and its
    rms (``spec`` their structure): (ViscousResult, fallback scalars,
    (x_tr upper, x_tr lower)). Makes one side march of 2P lanes (the
    verdict's oracle) and one wake march of P (the fallback's)."""
    system, sc, warm_state, zz, rms = graphs.unflatten(spec, flat)
    pan, grid = system.op.pan, system.grid
    dtype = grid.xi_u.dtype
    nu = system.nu
    n_crit_t = system.n_crit
    x_trip_u_t, x_trip_l_t = system.x_trip_u, system.x_trip_l
    p = zz.shape[0]

    # Transition fronts from the solved n field (0.5-crossing of the
    # blend weight, interpolated).
    def at(a, j):
        return a.gather(-1, j[..., None])[..., 0]

    def xtr_of(z_side, x, xt, x_trip_side):
        w = _w_station(z_side[..., 3], xt, n_crit_t[:, None],
                       x_trip_side[:, None])
        hit = w >= 0.5
        i = hit.to(torch.int32).argmax(-1)
        i1 = i.clamp(1, x.shape[-1] - 1)
        w1, w0 = at(w, i1), at(w, i1 - 1)
        dw = w1 - w0
        frac = clip((0.5 - w0) / torch.where(torch.abs(dw) < 1e-12, 1.0, dw),
                    0.0, 1.0)
        x0 = at(x, i1 - 1)
        xc = x0 + frac * (at(x, i1) - x0)
        xc = torch.where(i == 0, x[..., 0], xc)
        return torch.where(hit.any(-1), xc, 2.0)

    # ── extract the solution ────────────────────────────────────────────
    zu, zl, zw = _unpack(zz, m_s, n_w)
    xtr_u = xtr_of(zu, grid.x_u, grid.xt_u, x_trip_u_t)
    xtr_l = xtr_of(zl, grid.x_l, grid.xt_l, x_trip_l_t)
    w_u = _w_station(zu[..., 3], grid.xt_u, n_crit_t[:, None],
                     x_trip_u_t[:, None])
    w_l = _w_station(zl[..., 3], grid.xt_l, n_crit_t[:, None],
                     x_trip_l_t[:, None])

    m_w = torch.exp(zw[..., 1])
    ue_u, ue_l, ue_w, vt, sigma_b, sigma_w = _ue_from_m(
        system.op, system.wop, grid, system.vt0, torch.exp(zu[..., 1]),
        torch.exp(zl[..., 1]), m_w)

    cp = 1.0 - vt * vt
    cl_c, cm, _cdp_raw = _forces_from_cp(pan, cp, sc["alpha"])

    # Squire-Young extrapolation from the wake end.
    th_w_end = torch.exp(zw[..., -1, 0])
    d_w_end = m_w[..., -1] / ue_w[..., -1]
    h_end = clip(d_w_end / maximum(th_w_end, 1e-10), 1.0, 2.5)
    ue_end = clip(ue_w[..., -1], 0.2, 1.5)
    cd = 2.0 * th_w_end * ue_end ** (0.5 * (h_end + 5.0))

    def side_out(z, ue, xi, x, y, w, xtr):
        theta = torch.exp(z[..., 0])
        dstar = torch.exp(z[..., 1]) / ue
        hk = clip(dstar / maximum(theta, 1e-10), 1.005, 12.0)
        ret = maximum(ue * theta / nu[:, None], 1.0)
        cf = (1.0 - w) * cl.lam_cf(hk, ret) + w * cl.turb_cf(hk, ret)
        turb = w > 0.5
        # ``sep`` (the reported fraction): physical detachment onset;
        # ``sep_gate`` (the verdict's cap): the march's Hk caps;
        # ``sep_rear`` (scales cd_hi and the deficit band): detachment of
        # turbulent rear-half stations.
        sep = hk > torch.where(turb, 2.9, cl.HK_LAM_MAX)
        sep_gate = hk > torch.where(turb, cl.HK_TURB_MAX, cl.HK_LAM_MAX)
        rear = x > 0.5
        sep_rear = (torch.sum((turb & (hk > 2.9) & rear).to(x.dtype), -1)
                    / maximum(torch.sum(rear.to(x.dtype), -1), 1.0))
        side = SideBL(x=x, y=y, s=xi, ue=ue, theta=theta, dstar=dstar,
                      hk=hk, cf=cf, turb=turb,
                      x_transition=clip(minimum(xtr, x[..., -1]), 0.0, 1.0))
        return side, cf, sep, sep_gate, sep_rear

    upper, cf_u, sep_u, sepg_u, sep_rear_u = side_out(
        zu, ue_u, grid.xi_u, grid.x_u, grid.y_u, w_u, xtr_u)
    lower, cf_l, sep_l, sepg_l, sep_rear_l = side_out(
        zl, ue_l, grid.xi_l, grid.x_l, grid.y_l, w_l, xtr_l)

    cdf = (_friction_drag(cf_u, ue_u, grid.x_u)
           + _friction_drag(cf_l, ue_l, grid.x_l))
    cdp = cd - cdf

    sep_fraction = 0.5 * (torch.mean(sep_u.to(dtype), -1)
                          + torch.mean(sep_l.to(dtype), -1))
    sep_gate_fraction = 0.5 * (torch.mean(sepg_u.to(dtype), -1)
                               + torch.mean(sepg_l.to(dtype), -1))
    sep_rear_fraction = maximum(sep_rear_u, sep_rear_l)

    # Physical sanity joins the rms test in the verdict: a CL beyond the
    # inviscid one, a lift deficit beyond the separation-widened band, or
    # a CD outside the envelope for this Re marks a wrong basin.
    reynolds_t = sc["re"]
    cl_inv = sc["cl_inv"]
    deficit_band = ((0.35 + 0.8 * clip(sep_rear_fraction, 0.0, 0.4))
                    * torch.abs(cl_inv))
    cl_sane = ((torch.abs(cl_c - cl_inv) < maximum(deficit_band, 0.15))
               & (torch.abs(cl_c) < 1.05 * torch.abs(cl_inv) + 0.03))
    cd_lo = 1.0 / torch.sqrt(reynolds_t)
    cd_hi = (_CD_HI_COEF * reynolds_t ** -0.2
             + _CD_HI_SEP * clip(sep_rear_fraction, 0.0, 0.4))
    cd_sane = (cd > cd_lo) & (cd < cd_hi)
    finite = (torch.isfinite(zz).all(-1) & torch.isfinite(cl_c)
              & torch.isfinite(cd))

    # Oracle check: a march over the converged edge velocities must
    # reproduce the system's TE momentum thickness. The reference marches
    # four lanes a point; under the default gates only the first two (each
    # side with free amplification, forced at min(system front, trip))
    # feed the verdict, so those are marched: 2P lanes.
    bl_chk = kernel.march_side(
        torch.cat([grid.xi_u, grid.xi_l]), torch.cat([ue_u, ue_l]),
        torch.cat([grid.x_u, grid.x_l]), torch.cat([nu, nu]),
        torch.cat([n_crit_t, n_crit_t]),
        torch.cat([minimum(xtr_u, sc["x_trip"]),
                   minimum(xtr_l, sc["x_trip_lo"])]))
    ratio = (bl_chk.theta[:p, -1] + bl_chk.theta[p:, -1]) / maximum(
        torch.exp(zu[..., -1, 0]) + torch.exp(zl[..., -1, 0]), 1e-10)
    march_consistent = (ratio < 1.6) & ((ratio > 0.6)
                                        | (sep_rear_fraction > 0.02))

    converged = (finite & (rms < _RMS_OK) & (sep_gate_fraction < 0.40)
                 & cl_sane & cd_sane & march_consistent)

    res = ViscousResult(
        cl=cl_c, cd=cd, cdp=cdp, cm=cm, cp=cp, upper=upper, lower=lower,
        converged=converged, sep_fraction=sep_fraction,
        sigma=sigma_b, sigma_wake=sigma_w)
    fb = _fallback_scalars(system.op, system.wop, grid, system.vt0,
                           warm_state, sc["alpha"], nu, dtype, cl_inv=cl_inv)
    return res, fb, (xtr_u, xtr_l)


def _lane0(tree):
    """Lane 0 of every tensor of a (nested) tuple: the one-lane case."""
    if isinstance(tree, torch.Tensor):
        return tree[0]
    vals = [_lane0(t) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _one_state(init_zz, init_xtr_u, init_xtr_l):
    return (init_zz.reshape(1, -1), init_xtr_u, init_xtr_l)


def solve_viscous_newton(
    op: InviscidOperator,
    alpha_deg,
    reynolds,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    n_stations: int = 96,
    n_wake: int = 20,
    warm_iters: int = 8,
    newton_iters: int = 12,
    outer_rounds: int = 4,
    x_forced_transition_lower: float | None = None,
) -> ViscousResult:
    """Coupled viscous solve at one (alpha, Re) by simultaneous Newton
    with transition inside the system, on the operator's device: up to
    ``outer_rounds`` restart rounds of ``newton_iters`` LM iterations,
    exiting early once settled. Same result contract as
    ``coupled.solve_viscous``. ``x_forced_transition_lower``: a separate
    lower-surface trip (``None``: both use ``x_forced_transition``). The
    one-lane case of the lane solve."""
    res, _fb, _state = _solve_lanes(
        op, alpha_deg, reynolds, n_crit, x_forced_transition, n_stations,
        n_wake, warm_iters, newton_iters, outer_rounds,
        x_trip_lower=x_forced_transition_lower)
    return _lane0(res)


def _merge_point(res, fb):
    newton_out = (res.cl, res.cd, res.cdp, res.cm, res.converged,
                  res.upper.x_transition, res.lower.x_transition,
                  res.sep_fraction)
    use_newton = res.converged
    merged = tuple(torch.where(use_newton, a, b)
                   for a, b in zip(newton_out, fb))
    converged = use_newton | fb[4]
    return merged[:4] + (converged,) + merged[5:]


def _points_out(res, fb, state):
    return _merge_point(res, fb), (res.converged, state)


def solve_polar_points(
    op,
    alphas,
    reynolds,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    n_stations: int = 96,
    n_wake: int = 20,
    warm_iters: int = 8,
    newton_iters: int = 10,
    outer_rounds: int = 3,
):
    """P polar points solved side by side (the reference's ``vmap`` of
    ``solve_polar_point``): one lane a point, every lane through the same
    LM iterations, a settled lane frozen. ``op`` is one operator shared by
    every lane (a polar) or a sequence of P (a batch of geometries);
    ``alphas`` and ``reynolds`` are one a lane or shared. Returns
    ((cl, cd, cdp, cm, converged, xtr_u, xtr_l, sep_fraction),
    (newton_converged, (zz, xtr_u, xtr_l))), each (P,) or (P, n3)."""
    return _points_out(*_solve_lanes(
        op, alphas, reynolds, n_crit, x_forced_transition, n_stations,
        n_wake, warm_iters, newton_iters, outer_rounds))


def solve_polar_point(
    op: InviscidOperator,
    alpha_deg,
    reynolds,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    n_stations: int = 96,
    n_wake: int = 20,
    warm_iters: int = 8,
    newton_iters: int = 10,
    outer_rounds: int = 3,
):
    """One polar point: Newton scalars where converged, else the warm-start
    direct-trajectory fallback. Returns ((cl, cd, cdp, cm, converged,
    xtr_u, xtr_l, sep_fraction), (newton_converged, final_state)): the
    one-lane case of ``solve_polar_points``."""
    return _lane0(solve_polar_points(
        op, alpha_deg, reynolds, n_crit, x_forced_transition, n_stations,
        n_wake, warm_iters, newton_iters, outer_rounds))


def solve_viscous_newton_cont(
    op: InviscidOperator,
    alpha_deg,
    reynolds,
    init_zz,
    init_xtr_u,
    init_xtr_l,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    n_stations: int = 96,
    n_wake: int = 20,
    warm_iters: int = 1,
    newton_iters: int = 14,
    outer_rounds: int = 3,
) -> ViscousResult:
    """Full-result continuation solve from a donor state (the single-point
    analysis path's rescue); ``state_from_numpy`` carries a reference
    donor across."""
    res, _fb, _state = _solve_lanes(
        op, alpha_deg, reynolds, n_crit, x_forced_transition, n_stations,
        n_wake, warm_iters, newton_iters, outer_rounds,
        init_state=_one_state(init_zz, init_xtr_u, init_xtr_l))
    return _lane0(res)


def solve_polar_point_cont(
    op: InviscidOperator,
    alpha_deg,
    reynolds,
    init_zz,
    init_xtr_u,
    init_xtr_l,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    n_stations: int = 96,
    n_wake: int = 20,
    warm_iters: int = 1,
    newton_iters: int = 14,
    outer_rounds: int | None = None,
    cont_slack_add=0.05,
    cont_slack_mul=0.5,
    cont_slack_add_l=None,
    cont_slack_mul_l=None,
    x_forced_transition_lower=None,
):
    """Continuation re-solve of one polar point from a donor state, with
    ``solve_polar_point``'s contract. The ``cont_slack_*`` arguments are
    the reference's donor-ceiling slacks, which its default path (the only
    one ported) does not read."""
    if outer_rounds is None:
        outer_rounds = _CONT_ROUNDS
    return _lane0(_points_out(*_solve_lanes(
        op, alpha_deg, reynolds, n_crit, x_forced_transition, n_stations,
        n_wake, warm_iters, newton_iters, outer_rounds,
        init_state=_one_state(init_zz, init_xtr_u, init_xtr_l),
        x_trip_lower=x_forced_transition_lower)))
