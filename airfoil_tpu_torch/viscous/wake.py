"""Wake influence operator for the viscous-inviscid coupling: port of
``airfoil_tpu/viscous/wake.py``.

A source sheet along a wake line that leaves the trailing edge along the TE
bisector and curves to the freestream: its maps to the body surface
velocity (through an RHS-only gamma adjustment on the factored vortex
system) and to the wake centerline edge velocity, all linear in the source
strengths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from airfoil_tpu_torch.inviscid.panel_solver import (
    InviscidOperator,
    _freestream,
    _gamma_columns,
    _kernels,
    _local_frame,
    _refined_solve,
    _te_maps,
    _to_global,
)
from airfoil_tpu_torch.numerics import clip
from airfoil_tpu_torch.paneling import Paneling, panel_geometry

__all__ = ["WakeOperator", "build_wake_operator", "blend_te_continuity"]


class WakeOperator(NamedTuple):
    wpan: Paneling            # wake-line paneling (Mw panels)
    xi: torch.Tensor          # (Mw,) arc distance of wake midpoints from TE
    dvt_dsigw: torch.Tensor   # (N, Mw) body Vt sensitivity to wake sigma
    uw0: torch.Tensor         # (Mw,) wake Ue at zero transpiration
    wb: torch.Tensor          # (Mw, N) wake Ue sensitivity to body sigma
    ww: torch.Tensor          # (Mw, Mw) wake Ue sensitivity to wake sigma


def _source_maps(px, py, pan: Paneling, self_mask=None):
    """Global-frame (u, v) per unit source strength of ``pan``'s panels."""
    xi, eta, l = _local_frame(px, py, pan)
    _u_c, _v_c, _u_r, _v_r, u_s, v_s = _kernels(xi, eta, l, self_mask)
    return _to_global(u_s, v_s, pan)


def _vortex_maps(px, py, pan: Paneling, self_mask=None):
    """Global-frame (u, v) per unit nodal vorticity (gamma columns),
    including the TE gap panel's contribution to columns 0 / N."""
    xi, eta, l = _local_frame(px, py, pan)
    u_c, v_c, u_r, v_r, _u_s, _v_s = _kernels(xi, eta, l, self_mask)
    ua, va = _to_global(u_c - u_r, v_c - v_r, pan)
    ub, vb = _to_global(u_r, v_r, pan)
    ug, vg = _gamma_columns(ua, ub), _gamma_columns(va, vb)
    u_te, v_te = _te_maps(px, py, pan)
    ug[:, 0] += u_te
    ug[:, -1] -= u_te
    vg[:, 0] += v_te
    vg[:, -1] -= v_te
    return ug, vg


def build_wake_operator(
    op: InviscidOperator,
    alpha_deg,
    n_wake: int = 32,
    wake_length: float = 1.0,
) -> WakeOperator:
    """Build the wake line and its influence maps for one alpha."""
    pan = op.pan
    n = pan.xm.shape[0]
    dtype, dev = pan.xm.dtype, pan.xm.device
    uinf, vinf = _freestream(alpha_deg, pan.xm)

    # Wake line from the TE midpoint, leaving along the TE bisector (panel
    # 0 runs TE->LE on the upper side, panel N-1 LE->TE on the lower) and
    # turning to the freestream over the wake length.
    te_x = 0.5 * (pan.xp[0] + pan.xp[-1])
    te_y = 0.5 * (pan.yp[0] + pan.yp[-1])
    bx = 0.5 * (-pan.tx[0] + pan.tx[n - 1])
    by = 0.5 * (-pan.ty[0] + pan.ty[n - 1])
    bnorm = clip(torch.hypot(bx, by), 1e-6)
    bx, by = bx / bnorm, by / bnorm
    u = torch.linspace(0.0, 1.0, n_wake + 1, dtype=dtype, device=dev)
    frac = u ** 1.4
    w_dir = frac ** 0.7
    dxs = (1.0 - w_dir) * bx + w_dir * uinf
    dys = (1.0 - w_dir) * by + w_dir * vinf
    dnorm = clip(torch.hypot(dxs, dys), 1e-6)
    dxs, dys = dxs / dnorm, dys / dnorm
    dfrac = torch.diff(frac)
    step_x = 0.5 * (dxs[:-1] + dxs[1:]) * dfrac * wake_length
    step_y = 0.5 * (dys[:-1] + dys[1:]) * dfrac * wake_length
    zero = torch.zeros(1, dtype=dtype, device=dev)
    wx = te_x + torch.cat([zero, torch.cumsum(step_x, 0)])
    wy = te_y + torch.cat([zero, torch.cumsum(step_y, 0)])
    # Nudge the first node slightly off the TE so body-panel kernels stay
    # regular at the wake's first control point.
    wx[0] += 1e-4 * bx
    wy[0] += 1e-4 * by
    wpan = panel_geometry(wx, wy)
    xi = 0.5 * (wpan.s[:-1] + wpan.s[1:])

    # Wake sigma -> body Vt (via RHS-only gamma adjustment); the sharp-TE
    # blended rows scale their RHS by ``rhs_scale``.
    us_b, vs_b = _source_maps(pan.xm, pan.ym, wpan)      # (N, Mw)
    bn_w = us_b * pan.nx[:, None] + vs_b * pan.ny[:, None]
    bn_w = bn_w * op.rhs_scale[:, None]
    bt_w = us_b * pan.tx[:, None] + vs_b * pan.ty[:, None]
    rhs = torch.cat([-bn_w, bn_w.new_zeros((1, n_wake))], dim=0)
    g_w = _refined_solve(op.a_full, op.lu, op.piv, rhs)  # (N+1, Mw)
    dvt_dsigw = op.at_full @ g_w + bt_w

    # Velocities at the wake midpoints, projected on the wake tangent.
    ug_w, vg_w = _vortex_maps(wpan.xm, wpan.ym, pan)     # (Mw, N+1)
    tg_w = ug_w * wpan.tx[:, None] + vg_w * wpan.ty[:, None]
    us_bw, vs_bw = _source_maps(wpan.xm, wpan.ym, pan)   # body sigma
    tb_w = us_bw * wpan.tx[:, None] + vs_bw * wpan.ty[:, None]
    self_mask = torch.eye(n_wake, dtype=torch.bool, device=dev)
    us_ww, vs_ww = _source_maps(wpan.xm, wpan.ym, wpan, self_mask)
    tw_w = us_ww * wpan.tx[:, None] + vs_ww * wpan.ty[:, None]

    t_free = uinf * wpan.tx + vinf * wpan.ty
    # gamma = gamma0 + dgamma_dsigma sigma_b + g_w sigma_w
    rhs0 = torch.cat([-(uinf * pan.nx + vinf * pan.ny), zero])
    gamma0 = _refined_solve(op.a_full, op.lu, op.piv, rhs0)
    uw0 = t_free + tg_w @ gamma0
    wb = tg_w @ op.dgamma_dsigma + tb_w
    ww = tg_w @ g_w + tw_w

    return WakeOperator(wpan, xi, dvt_dsigw, uw0, wb, ww)


def blend_te_continuity(xi, ue_w, ue_te):
    """Blend the sampled wake edge velocities toward the body TE value over
    the first 0.15 c: the wake edge velocity is continuous with the TE
    boundary-layer edge velocity (the potential-flow samples just behind
    the TE sit in the TE panels' near field). Linear in its inputs."""
    w = clip(xi / 0.15, 0.0, 1.0)
    w = w * w * (3.0 - 2.0 * w)
    return (1.0 - w) * ue_te + w * ue_w
