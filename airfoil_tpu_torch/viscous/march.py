"""Integral boundary-layer march, plain torch: port of
``airfoil_tpu/viscous/march.py``.

The von Karman momentum and kinetic-energy shape-parameter equations are
integrated station by station from the stagnation point with Falkner-Skan
initial conditions, e^N transition, Drela's shear-lag equation, a
0.7-implicit interval average and a fixed 8-iteration damped Newton solve
(3x3) per station; the reference's clamps, sticky flags and transition
bookkeeping are kept in its order.

The reference's ``lax.scan`` over stations is a Python loop here, and its
``vmap`` over the side pair is a leading lane axis L: ``s, ue, x`` are
(L, M) (or (M,) for one lane) and ``nu``, ``n_crit`` and
``x_forced_transition`` are per lane. The Newton Jacobian is forward mode,
as the reference's ``jax.jacfwd``: one evaluation of ``_step_residual`` on
a ``numerics.Dual`` seeded with the three unit directions gives every
lane's 3x3 Jacobian and its residual together. (``torch.func.jacfwd``
under ``torch.func.vmap`` gives the same Jacobian, and the tests hold the
two together, but its per-op dispatch made a Newton iteration 80 ms on a
CPU against ~5 ms.)

This is the plain version of the CUDA march kernel (``viscous/kernel.py``,
``csrc/bl_march.cu``): a few thousand small torch ops per Newton
iteration, so it is launch-bound on any device. Callers on the main path
go through ``viscous.kernel``, which takes this version only for CPU
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from airfoil_tpu_torch.device import DTYPE
from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.numerics import clip
from airfoil_tpu_torch.viscous import closures as cl

__all__ = ["BLState", "stagnation_ic", "march_side", "march_wake",
           "wake_ctau0"]

_NEWTON_ITERS = 8
_CTAU_INIT_FACTOR = 0.7
_KLAG = 5.6
# Implicit weighting of interval averages (0.5 trapezoidal, 1.0 backward
# Euler); 0.7 damps the Crank-Nicolson wiggle on clustered stations.
_AVG_W = 0.7
_HK_RESET = 1.55
_HK_WAKE_CAP = 10.0


def _avg(f1, f2):
    return (1.0 - _AVG_W) * f1 + _AVG_W * f2


class BLState(NamedTuple):
    """Per-station boundary-layer arrays along one side (stag -> TE); with
    lanes every array has a leading lane axis."""

    theta: torch.Tensor    # momentum thickness
    dstar: torch.Tensor    # displacement thickness
    hk: torch.Tensor       # kinematic shape parameter
    cf: torch.Tensor       # skin-friction coefficient (edge-q normalised)
    amp: torch.Tensor      # e^N amplification factor (laminar region)
    ctau: torch.Tensor     # shear-stress coefficient (turbulent region)
    turb: torch.Tensor     # bool: station is turbulent
    separated: torch.Tensor  # bool: Hk cap engaged at this station
    x_transition: torch.Tensor  # chordwise transition location


def stagnation_ic(s1, ue1, nu):
    """Falkner-Skan (Hiemenz) stagnation-point initial condition:
    theta = sqrt(0.075 nu / K), H = 2.24, with K = Ue/s at the first
    station."""
    k = clip(ue1 / clip(s1, 1e-8), 1e-6)
    theta0 = torch.sqrt(0.075 * nu / k)
    return theta0, 2.24 * theta0


def _regime_quantities(theta, dstar, ue, nu, ctau, turb, wake=False):
    """Closure evaluations blended by regime flag; in wake mode Cf = 0 and
    the dissipation is the shear-stress term alone."""
    theta = clip(theta, 1e-10)
    hk = clip(dstar / theta, 1.02, 12.0)
    ret = clip(ue * theta / nu, 1.0)

    hs_l = cl.lam_hstar(hk)
    hs_t = cl.turb_hstar(hk, ret)
    hs = nm.where(turb, hs_t, hs_l)

    cf_l = cl.lam_cf(hk, ret)
    cf_t = cl.turb_cf(hk, ret)
    cf = nm.where(turb, cf_t, cf_l)

    cd_l = cl.lam_diss(hk, ret, hs_l)
    cd_t = cl.turb_diss(hk, ret, ctau, hs_t)
    cd = nm.where(turb, cd_t, cd_l)

    if wake:
        cf = nm.zeros_like(cf)
        us = cl.turb_us(hk, hs_t)
        cd = clip(ctau, 0.0, 0.3) * (1.0 - us)

    return hk, ret, hs, cf, cd


def _step_residual(z2, carry1, st1, st2, nu, turb, wake=False):
    """Implicit-weighted residual for one interval; z2 = (ln t2, ln d2, a2)
    along its last axis, the other arguments (L,) per lane. Returns
    (L, 3)."""
    s1, ue1, _x1 = st1
    s2, ue2, _x2 = st2
    t1, d1, a1 = carry1
    t2 = nm.exp(z2[..., 0])
    d2 = nm.exp(z2[..., 1])
    a2 = z2[..., 2]

    ds = clip(s2 - s1, 1e-8)
    due = ue2 - ue1
    ue_m = _avg(ue1, ue2)
    t_m = _avg(t1, t2)

    ctau1 = nm.exp(clip(a1, -20.0, 0.0))
    ctau2 = nm.exp(clip(a2, -20.0, 0.0))
    hk1, ret1, hs1, cf1, cd1 = _regime_quantities(t1, d1, ue1, nu, ctau1,
                                                  turb, wake)
    hk2, ret2, hs2, cf2, cd2 = _regime_quantities(t2, d2, ue2, nu, ctau2,
                                                  turb, wake)

    h_m = _avg(hk1, hk2)
    hs_m = _avg(hs1, hs2)
    cf_m = _avg(cf1, cf2)
    cd_m = _avg(cd1, cd2)

    # von Karman momentum integral
    r1 = (t2 - t1) / ds + (2.0 + h_m) * (t_m / ue_m) * (due / ds) - 0.5 * cf_m
    # kinetic-energy shape parameter equation
    r2 = (t_m * (hs2 - hs1) / ds
          + hs_m * (1.0 - h_m) * (t_m / ue_m) * (due / ds)
          - (2.0 * cd_m - hs_m * 0.5 * cf_m))

    # Amplification (laminar) / shear-stress lag (turbulent)
    rate1 = cl.amplification_rate(hk1, t1, ret1)
    rate2 = cl.amplification_rate(hk2, t2, ret2)
    r3_lam = (a2 - a1) / ds - _avg(rate1, rate2)

    cteq1 = cl.turb_cteq(hk1, ret1, hs1)
    cteq2 = cl.turb_cteq(hk2, ret2, hs2)
    del1 = cl.delta_thickness(t1, d1, hk1)
    del2 = cl.delta_thickness(t2, d2, hk2)
    lag1 = _KLAG * (nm.sqrt(cteq1) - nm.sqrt(ctau1)) / (2.0 * del1)
    lag2 = _KLAG * (nm.sqrt(cteq2) - nm.sqrt(ctau2)) / (2.0 * del2)
    r3_turb = (a2 - a1) / ds - _avg(lag1, lag2)

    r3 = nm.where(turb, r3_turb, r3_lam)
    # Scale residuals to comparable magnitude (theta is tiny).
    t_floor = clip(t_m, 1e-10)
    return nm.stack([r1 / t_floor * ds,
                     r2 / t_floor * ds,
                     r3 * nm.where(turb, 1.0, ds)], dim=-1)


def _jacobian(z, carry1, st1, st2, nu, turb, wake: bool):
    """(J, r): the (L, 3, 3) Jacobian of the residual in z and the (L, 3)
    residual, from one evaluation on a ``Dual`` seeded with the three unit
    directions in every lane (forward mode, as ``jax.jacfwd``)."""
    basis = torch.eye(3, dtype=z.dtype, device=z.device)[:, None, :]
    r = _step_residual(nm.Dual(z, basis.expand(3, *z.shape)), carry1, st1,
                       st2, nu, turb, wake)
    return r.t.permute(1, 2, 0), r.v


def _newton(z, carry1, st1, st2, nu, turb, wake: bool):
    """The fixed-count damped Newton of one station for all lanes."""
    eye = 1e-8 * torch.eye(3, dtype=z.dtype, device=z.device)
    for _ in range(_NEWTON_ITERS):
        jac, r = _jacobian(z, carry1, st1, st2, nu, turb, wake)
        dz, info = torch.linalg.solve_ex(jac + eye, -r)
        dz = clip(dz, -0.5, 0.5)
        # A singular system gives non-finite steps in the reference's LU
        # solve; LAPACK reports it in ``info`` instead.
        bad = ~torch.isfinite(dz).all(-1) | (info != 0)
        dz = torch.where(bad[:, None], 0.0, dz)
        z = z + dz
    return z


def _lanes(a, like: torch.Tensor) -> torch.Tensor:
    """A per-lane parameter (a number, a 0-d or an (L,) tensor) as an (L,)
    float32 tensor on ``like``'s device; a number is filled in on the
    device, so no host-to-device copy waits for the card."""
    n = like.shape[0]
    if isinstance(a, torch.Tensor):
        return a.to(device=like.device, dtype=DTYPE).expand(n).contiguous()
    return torch.full((n,), float(a), dtype=DTYPE, device=like.device)


def _as_lanes(*arrays):
    one = arrays[0].dim() == 1
    return one, [a.reshape(-1, a.shape[-1]) for a in arrays]


def _growth_clamp(z, t1, d1):
    """theta/dstar may at most double (or halve) per station."""
    lt1 = torch.log(clip(t1, 1e-10))
    ld1 = torch.log(clip(d1, 1e-10))
    z0 = clip(z[:, 0], lt1 - 0.7, lt1 + 0.7)
    z1 = clip(z[:, 1], ld1 - 0.7, ld1 + 0.7)
    return (torch.exp(clip(z0, -23.0, 0.0)),
            torch.exp(clip(z1, -23.0, 1.0)))


def march_side(s, ue, x, nu, n_crit=9.0, x_forced_transition=1.0
               ) -> BLState:
    """March the integral BL over each lane's stations (stag -> TE).

    ``s``: (L, M) or (M,) arc distance from the stagnation point (s[0]
    small, not 0). ``ue``: positive edge velocities / U_inf. ``x``:
    chordwise positions for transition bookkeeping. ``nu`` = 1/Re (chord
    units), ``n_crit`` and ``x_forced_transition`` scalars or (L,).
    """
    one, (s, ue, x) = _as_lanes(s, ue, x)
    m = s.shape[1]
    nu = _lanes(nu, s)
    n_crit = _lanes(n_crit, s)
    x_forced = _lanes(x_forced_transition, s)
    theta0, dstar0 = stagnation_ic(s[:, 0], ue[:, 0], nu)

    # Trip coordinate: chordwise x masked to -1 before the leading edge
    # (the strip's x wraps around the LE; see the reference).
    idx = torch.arange(m, device=s.device)
    x_trip_c = torch.where(idx[None, :] >= torch.argmin(x, 1, keepdim=True),
                           x, -1.0)

    t1, d1 = theta0, dstar0
    a1 = torch.zeros_like(theta0)
    false = torch.zeros_like(theta0, dtype=torch.bool)
    turb1, tripped, lam_sep1 = false, false, false
    xtr = x[:, -1]
    seprun1 = torch.zeros_like(theta0)
    outs = []
    for k in range(m - 1):
        s1, ue1, x1, xt1 = s[:, k], ue[:, k], x[:, k], x_trip_c[:, k]
        s2, ue2, x2 = s[:, k + 1], ue[:, k + 1], x[:, k + 1]

        # Transition trigger at interval start: free (amplification),
        # trip, or a laminar separation that has run 0.05c.
        lam1 = ~turb1
        becomes_turb = lam1 & ((a1 >= n_crit) | (xt1 >= x_forced)
                               | (seprun1 > 0.05))
        turb2 = turb1 | becomes_turb
        xtr = torch.where(becomes_turb & ~tripped, x1, xtr)
        tripped = tripped | becomes_turb

        # Transition treatment: theta continuous, shape parameter reset
        # toward the attached turbulent value, ctau from equilibrium.
        d1 = torch.where(becomes_turb,
                         torch.minimum(d1, _HK_RESET * t1), d1)
        hk1 = clip(d1 / clip(t1, 1e-10), 1.02, 12.0)
        ret1 = clip(ue1 * t1 / nu, 1.0)
        hs1 = cl.turb_hstar(hk1, ret1)
        cteq1 = cl.turb_cteq(hk1, ret1, hs1)
        a1 = torch.where(becomes_turb,
                         torch.log(_CTAU_INIT_FACTOR * cteq1), a1)

        st1 = (s1, ue1, x1)
        st2 = (s2, ue2, x2)
        carry1 = (t1, d1, a1)
        z = torch.stack([torch.log(clip(t1, 1e-10)),
                         torch.log(clip(d1, 1e-10)), a1], dim=1)
        z = _newton(z, carry1, st1, st2, nu, turb2, wake=False)

        t2, d2 = _growth_clamp(z, t1, d1)
        a2 = clip(z[:, 2], a1 - 3.0, a1 + 3.0)

        # Cap Hk to step over the direct-mode separation singularity; a
        # separated laminar layer stays pinned at the cap until transition.
        hk_cap = torch.where(turb2, cl.HK_TURB_MAX, cl.HK_LAM_MAX)
        hk2_raw = d2 / clip(t2, 1e-10)
        sep = hk2_raw > hk_cap
        d2 = torch.where(sep, hk_cap * t2, d2)
        lam2 = ~turb2
        lam_sep2 = lam2 & (lam_sep1 | (lam2 & (hk2_raw > 4.05)))
        d2 = torch.where(lam_sep2, clip(d2, cl.HK_LAM_MAX * t2), d2)
        sep = sep | lam_sep2
        a2 = torch.where(turb2, clip(a2, -18.0, -1.0), clip(a2, 0.0, 30.0))
        # Laminar amplification integrated explicitly from the solved
        # thickness states (exact for this n-independent rate).
        hk1_est = clip(d1 / clip(t1, 1e-10), 1.02, 12.0)
        ret1_est = clip(ue1 * t1 / nu, 1.0)
        hk2_est = clip(d2 / clip(t2, 1e-10), 1.02, 12.0)
        ret2_est = clip(ue2 * t2 / nu, 1.0)
        rate_lam = _avg(cl.amplification_rate(hk1_est, t1, ret1_est),
                        cl.amplification_rate(hk2_est, t2, ret2_est))
        ds12 = clip(s2 - s1, 1e-8)
        a2 = torch.where(turb2, a2, clip(a1 + ds12 * rate_lam, 0.0, 30.0))

        ctau2 = torch.exp(clip(a2, -20.0, 0.0))
        hk2, _ret2, _hs2, cf2, _cd2 = _regime_quantities(
            t2, d2, ue2, nu, ctau2, turb2)

        # Chordwise run length of the current laminar-separated stretch.
        seprun1 = torch.where(lam_sep2, seprun1 + torch.abs(x2 - x1), 0.0)

        outs.append((t2, d2, hk2, cf2,
                     torch.where(turb2, torch.nan, a2),
                     torch.where(turb2, ctau2, torch.nan),
                     turb2, sep))
        t1, d1, a1, turb1, lam_sep1 = t2, d2, a2, turb2, lam_sep2

    # The stagnation station.
    hk0 = dstar0 / theta0
    ret0 = clip(ue[:, 0] * theta0 / nu, 1.0)
    first = (theta0, dstar0, hk0, cl.lam_cf(hk0, ret0),
             torch.zeros_like(theta0), torch.full_like(theta0, torch.nan),
             false, false)
    cols = [torch.stack(c, dim=1) for c in zip(first, *outs)]
    bl = BLState(*cols, x_transition=xtr)
    if one:
        bl = BLState(*(a[0] for a in bl))
    return bl


def march_wake(s, ue, nu, theta0, dstar0, ctau0):
    """March the merged free wake downstream of the trailing edge.

    ``s`` (L, Mw) or (Mw,) is arc distance from the TE (s[0] small), ``ue``
    the wake centerline edge velocity; ``theta0``, ``dstar0``, ``ctau0``
    the merged TE states. Always turbulent closures, Cf = 0, shear-driven
    dissipation only. Returns (theta, dstar, hk).
    """
    one, (s, ue) = _as_lanes(s, ue)
    mw = s.shape[1]
    nu = _lanes(nu, s)
    t1 = _lanes(theta0, s)
    d1 = _lanes(dstar0, s)
    a1 = torch.log(clip(_lanes(ctau0, s), 1e-7, 0.3))
    turb = torch.ones_like(t1, dtype=torch.bool)
    outs = []
    for k in range(mw - 1):
        st1 = (s[:, k], ue[:, k], s[:, k])
        st2 = (s[:, k + 1], ue[:, k + 1], s[:, k + 1])
        z = torch.stack([torch.log(clip(t1, 1e-10)),
                         torch.log(clip(d1, 1e-10)), a1], dim=1)
        z = _newton(z, (t1, d1, a1), st1, st2, nu, turb, wake=True)
        t2, d2 = _growth_clamp(z, t1, d1)
        a2 = clip(z[:, 2], -18.0, -1.0)
        # Wake Hk floor is 1 (uniform profile); cap generously.
        hk2 = d2 / clip(t2, 1e-10)
        d2 = torch.where(hk2 > _HK_WAKE_CAP, _HK_WAKE_CAP * t2, d2)
        hk2 = clip(hk2, 1.0, _HK_WAKE_CAP)
        outs.append((t2, d2, hk2))
        t1, d1, a1 = t2, d2, a2

    t0, d0 = _lanes(theta0, s), _lanes(dstar0, s)
    first = (t0, d0, d0 / clip(t0, 1e-10))
    cols = [torch.stack(c, dim=1) for c in zip(first, *outs)]
    if one:
        cols = [c[0] for c in cols]
    return tuple(cols)


def wake_ctau0(bl_u: BLState, bl_l: BLState, th0, ds0, ue_te, nu):
    """Initial wake shear-stress coefficient from the merged TE states: the
    theta-weighted mean of the two sides' TE ctau, a laminar side
    contributing XFOIL's transition-onset fraction of its equilibrium ctau,
    floored at 0.7x the equilibrium ctau of the merged inlet state."""
    ret0 = clip(ue_te * th0 / nu, 50.0)

    def side_ct(bl):
        hk_te = clip(bl.hk[..., -1], 1.05, 8.0)
        hs_te = cl.turb_hstar(hk_te, ret0)
        cteq = cl.turb_cteq(hk_te, ret0, hs_te)
        onset = 1.8 * torch.exp(-3.3 / clip(hk_te - 1.0, 0.2))
        lam_val = clip(onset, 0.2, 1.0) * cteq
        c = torch.where(torch.isnan(bl.ctau[..., -1]), lam_val,
                        bl.ctau[..., -1])
        return clip(c, 1e-5, 0.3)

    ct0 = ((side_ct(bl_u) * bl_u.theta[..., -1]
            + side_ct(bl_l) * bl_l.theta[..., -1]) / clip(th0, 1e-10))
    hk0 = clip(ds0 / clip(th0, 1e-10), 1.05, 8.0)
    hs0 = cl.turb_hstar(hk0, ret0)
    ct_floor = 0.7 * cl.turb_cteq(hk0, ret0, hs0)
    return clip(clip(ct0, ct_floor), 1e-5, 0.3)
