"""Integral boundary-layer closure correlations (incompressible): port of
``airfoil_tpu/viscous/closures.py``.

Falkner-Skan laminar fits and Drela's equilibrium + lag turbulent set
(Drela 1989; Drela & Giles 1987), elementwise in (Hk, Re_theta, Ctau). The
reference's branch and clip semantics are kept exactly, because the march
differentiates these functions in forward mode:

- ``jnp.where`` selects, so the NaN in the unselected branch of
  ``(4 - hk) ** 5.5`` or ``(h0 - hk) ** 1.6`` reaches neither the value
  nor its tangent (``numerics.where`` selects tangents the same way);
- ``jnp.maximum`` and ``jnp.clip`` split the derivative 0.5/0.5 at a tie,
  so bounds go through ``numerics.clip``, never ``torch.clamp``, whose
  derivative at the bound is 1;
- ``jnp.log10`` is ``log(x) * 0.4342944920063019`` in float32, as JAX
  lowers it (``numerics.log10``).

Every function takes tensors or ``numerics.Dual`` numbers (the march's
forward-mode Jacobian).

The CUDA march (``csrc/bl_closures.cuh``) implements the same functions
once more, templated on its scalar type.
"""

from __future__ import annotations

import torch

from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.numerics import clip, interp, log10

__all__ = [
    "lam_hstar", "lam_cf", "lam_diss", "amplification_rate",
    "log10_ret_crit",
    "turb_hstar", "turb_cf", "turb_us", "turb_cteq", "turb_diss",
    "delta_thickness", "HK_LAM_MAX", "HK_TURB_MAX",
]

HK_LAM_MAX = 5.8
HK_TURB_MAX = 4.0
_HK_MIN = 1.02


def _clip_hk(hk):
    return clip(hk, _HK_MIN, 12.0)


# ── Laminar (Falkner-Skan fits, Drela & Giles 1987) ─────────────────────────

def lam_hstar(hk):
    """Kinetic-energy shape parameter H* = theta*/theta."""
    hk = _clip_hk(hk)
    lo = 1.515 + 0.076 * (4.0 - hk) ** 2 / hk
    hi = 1.515 + 0.040 * (hk - 4.0) ** 2 / hk
    return nm.where(hk < 4.0, lo, hi)


def lam_cf(hk, ret):
    """Skin friction: returns Cf (not Cf/2)."""
    hk = _clip_hk(hk)
    ret = clip(ret, 1.0)
    lo = -0.067 + 0.01977 * (7.4 - hk) ** 2 / (hk - 1.0)
    hi = -0.067 + 0.022 * (1.0 - 1.4 / (hk - 6.0)) ** 2
    half_cf_ret = nm.where(hk < 7.4, lo, hi)
    return 2.0 * half_cf_ret / ret


def lam_diss(hk, ret, hstar):
    """Dissipation coefficient CD (per unit: 2*CD enters the KE equation)."""
    hk = _clip_hk(hk)
    ret = clip(ret, 1.0)
    lo = 0.207 + 0.00205 * (4.0 - hk) ** 5.5
    hi = 0.207 - 0.003 * (hk - 4.0) ** 2 / (1.0 + 0.02 * (hk - 4.0) ** 2)
    two_cd_ret_over_hstar = nm.where(hk < 4.0, lo, hi)
    return 0.5 * two_cd_ret_over_hstar * hstar / ret


def log10_ret_crit(hk):
    """log10 of the critical Re_theta for envelope amplification onset
    (Drela 1989 fit)."""
    hk1 = clip(clip(hk, 1.05, 12.0) - 1.0, 0.1)
    return ((1.415 / hk1 - 0.489) * nm.tanh(20.0 / hk1 - 12.9)
            + 3.295 / hk1 + 0.44)


# Airfoil-regime H-modulation of the amplification rate and the
# separated-shear boost: the reference's calibration, unchanged (see
# airfoil_tpu/viscous/closures.py for its derivation).
_AMP_MOD_HK = (2.55, 2.90, 3.20, 3.60, 4.20, 5.20)
_AMP_MOD_G = (1.00, 0.70, 0.62, 0.60, 0.65, 0.70)
_SEP_BOOST = 60.0


_AMP_MOD_KNOTS: dict = {}     # device -> (hk, g) knot tensors


def _amp_h_mod(hk):
    dev = nm.value(hk).device
    knots = _AMP_MOD_KNOTS.get(dev)
    if knots is None:
        knots = _AMP_MOD_KNOTS.setdefault(dev, tuple(
            torch.tensor(k, dtype=torch.float32, device=dev)
            for k in (_AMP_MOD_HK, _AMP_MOD_G)))
    return interp(hk, *knots)


def _sep_boost(hk):
    s = clip((hk - 4.6) / 0.9, 0.0, 1.0)
    return _SEP_BOOST * s * s * (3.0 - 2.0 * s)


def amplification_rate(hk, theta, ret):
    """e^N envelope amplification dn~/ds (Drela's 1989 fit, H-modulated):
    zero below the critical Re_theta, smoothstepped on over the 0.16
    decades above it (XFOIL's RNORM ramp)."""
    hk = clip(hk, 2.1, 12.0)
    theta = clip(theta, 1e-12)
    ret = clip(ret, 1.0)

    hk1 = clip(hk - 1.0, 0.1)
    log10_retc = log10_ret_crit(hk)
    dn_dret = 0.01 * nm.sqrt(
        (2.4 * hk - 3.7 + 2.5 * nm.tanh(1.5 * hk - 4.65)) ** 2 + 0.25)
    ell = (6.54 * hk - 14.07) / hk ** 2
    m = (0.058 * (hk - 4.0) ** 2 / hk1 - 0.068) / ell
    rate = dn_dret * 0.5 * (m + 1.0) * ell / theta

    s = clip((log10(ret) - log10_retc) / 0.16, 0.0, 1.0)
    gate = s * s * (3.0 - 2.0 * s)
    return rate * gate * _amp_h_mod(hk) + _sep_boost(hk)


# ── Turbulent (Drela 1989 equilibrium + lag) ────────────────────────────────

def turb_hstar(hk, ret):
    """Turbulent kinetic-energy shape parameter."""
    hk = _clip_hk(hk)
    ret = clip(ret, 400.0)
    h0 = 3.0 + 400.0 / ret
    base = 1.505 + 4.0 / ret
    lo = base + (0.165 - 1.6 / nm.sqrt(ret)) * (h0 - hk) ** 1.6 / hk
    lnret = nm.log(ret)
    hi = base + (hk - h0) ** 2 * (
        0.04 / hk + 0.007 * lnret / (hk - h0 + 4.0 / lnret) ** 2)
    return nm.where(hk < h0, lo, hi)


def turb_cf(hk, ret):
    """Turbulent skin-friction coefficient (incompressible fit)."""
    hk = _clip_hk(hk)
    ret = clip(ret, 50.0)
    log10_ret = log10(ret)
    return (0.3 * nm.exp(-1.33 * hk)
            * log10_ret ** (-1.74 - 0.31 * hk)
            + 0.00011 * (nm.tanh(4.0 - hk / 0.875) - 1.0))


def turb_us(hk, hstar):
    """Equivalent normalised wall-slip velocity Us/Ue."""
    hk = _clip_hk(hk)
    us = 0.5 * hstar * (1.0 - 4.0 * (hk - 1.0) / (3.0 * hk))
    return clip(us, 0.0, 0.98)


def turb_cteq(hk, ret, hstar):
    """Equilibrium shear-stress coefficient Ctau_EQ."""
    hk = _clip_hk(hk)
    us = turb_us(hk, hstar)
    cteq = hstar * 0.015 * (hk - 1.0) ** 3 / ((1.0 - us) * hk ** 3)
    return clip(cteq, 1e-7, 0.3)


def turb_diss(hk, ret, ctau, hstar):
    """Turbulent dissipation coefficient CD = Cf/2 Us + Ctau (1 - Us)."""
    cf = turb_cf(hk, ret)
    us = turb_us(hk, hstar)
    return 0.5 * cf * us + clip(ctau, 0.0, 0.3) * (1.0 - us)


def delta_thickness(theta, dstar, hk):
    """Boundary-layer thickness estimate delta (for the lag equation)."""
    hk = _clip_hk(hk)
    return theta * (3.15 + 1.72 / (hk - 1.0)) + dstar
