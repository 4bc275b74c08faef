"""Single-point analysis with the reference's three-strategy fallback: port
of ``airfoil_tpu/polar/analyze.py``.

Strategy 1 solves the clean geometry, strategy 2 the smoothed one, each by
simultaneous Newton first, then a continuation rescue from a gentler
alpha, then the direct coupling; strategy 3 is the inviscid answer with
the reference's warning. The output contract is the reference's: Cp, the
coefficient dict with its ``mode`` tag, and the boundary-layer rows (upper
TE -> LE, lower LE -> TE, each ``{x, y, dstar, theta, cf, H}``) with both
transition locations.

The solves run on one device (``device``, else ``resolve_device()``); the
host reads each solve's ``converged`` to choose the next step, and the
answer at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.inviscid.programs import inviscid_program
from airfoil_tpu_torch.paneling import panel_geometry, repanel, smooth_geometry
from airfoil_tpu_torch.viscous.coupled import SideBL, ViscousResult
from airfoil_tpu_torch.viscous.coupled import solve_viscous
from airfoil_tpu_torch.viscous.newton import (
    solve_polar_point,
    solve_polar_point_cont,
    solve_viscous_newton,
    solve_viscous_newton_cont,
)

__all__ = ["AnalysisResult", "INVISCID_WARNING", "analyze_airfoil"]

INVISCID_WARNING = "INVISCID MODE - CD is unrealistically low"


@dataclass
class AnalysisResult:
    """JSON-ready single-point result (reference schema, main.py:605-615)."""

    cp_x: list
    cp_values: list
    coefficients: dict
    bl_data: dict | None
    mode: str
    strategy: int           # 1 viscous / 2 viscous+smoothed / 3 inviscid
    converged: bool
    sep_fraction: float = 0.0
    extras: dict = field(default_factory=dict)


def _host(a) -> np.ndarray:
    """A tensor (or array) as float64 numpy of its float32 values."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _side_rows(side: SideBL, reverse: bool) -> list[dict]:
    x, y = _host(side.x), _host(side.y)
    th, ds = _host(side.theta), _host(side.dstar)
    cf, hk = _host(side.cf), _host(side.hk)
    idx = range(len(x) - 1, -1, -1) if reverse else range(len(x))
    return [
        {
            "x": float(x[i]), "y": float(y[i]),
            "dstar": float(ds[i]), "theta": float(th[i]),
            "cf": float(cf[i]), "H": float(hk[i]),
        }
        for i in idx
    ]


def _bl_payload(res: ViscousResult) -> dict:
    xtr_u = float(res.upper.x_transition)
    xtr_l = float(res.lower.x_transition)
    return {
        # XFOIL DUMP convention: upper section TE -> LE (main.py:206-208).
        "upper": _side_rows(res.upper, reverse=True),
        "lower": _side_rows(res.lower, reverse=False),
        "transition_upper_x": xtr_u if xtr_u < 0.99 else None,
        "transition_lower_x": xtr_l if xtr_l < 0.99 else None,
    }


def warm_direct_solve(device=None) -> None:
    """Capture the graph of the direct solve that ``analyze_airfoil``'s
    last resort runs at its default 160 panels (one lane, the solver's
    defaults; ``viscous.graphs``), so that the first upload that needs it
    captures nothing: NACA 2412 at alpha 5, Re 1e6, on ``device`` (see
    ``resolve_device``); on the CPU the same solve runs eagerly."""
    from airfoil_tpu_torch.models import naca4

    dev = resolve_device(device)
    xp, yp = repanel(naca4(2, 4, 12, 60), 160, device=dev)
    solve_viscous(build_operator(panel_geometry(xp, yp)), 5.0, 1e6)


def analyze_airfoil(
    coords,
    reynolds: float,
    alpha: float,
    n_panels: int = 160,
    n_crit: float = 9.0,
    x_forced_transition: float = 1.0,
    device=None,
) -> AnalysisResult:
    """Three-strategy single-point analysis on ``device``.

    Strategy 1: viscous, clean geometry. Strategy 2: viscous, smoothed
    geometry (GDES SMOO, reference main.py:305-313). Strategy 3: inviscid
    fallback with no BL data and the reference's warning string
    (main.py:315-323,506).
    """
    dev = resolve_device(device)
    xp, yp = repanel(np.asarray(coords, np.float32), n_panels, device=dev)
    op = build_operator(panel_geometry(xp, yp))

    def coeffs(cl, cd, cdp, cm, mode):
        out = {
            "CL": round(float(cl), 4),
            "CD": round(float(cd), 6),
            "CDp": round(float(cdp), 6),
            "Cm": round(float(cm), 4),
            "mode": mode,
        }
        if mode == "inviscid":
            out["warning"] = INVISCID_WARNING
        return out

    def cp_x_of(the_op):
        # Midpoints of the operator actually solved (strategy 2's smoothed
        # paneling shifts them slightly).
        return [float(v) for v in _host(the_op.pan.xm)]

    def solve_best(the_op):
        """Simultaneous Newton first; when it flags a wrong basin, an
        alpha-continuation from a gentler operating point; finally the
        direct under-relaxed coupling."""
        kw = dict(n_crit=n_crit, x_forced_transition=x_forced_transition)
        res = solve_viscous_newton(the_op, float(alpha), float(reynolds),
                                   **kw)
        if bool(res.converged):
            return res

        a_t = float(alpha)
        a_seed = 0.6 * a_t if abs(a_t) > 3.0 else 0.0
        _m, (nok, st) = solve_polar_point(the_op, a_seed, float(reynolds),
                                          **kw)
        if bool(nok):
            # One intermediate hop when the gap is wide, then the target.
            hops = ([a_seed + 0.8 * (a_t - a_seed)]
                    if abs(a_t - a_seed) > 2.5 else [])
            for a_i in hops:
                _m, (nok_i, st_i) = solve_polar_point_cont(
                    the_op, a_i, float(reynolds), *st, **kw)
                if not bool(nok_i):
                    st = None
                    break
                st = st_i
            if st is not None:
                res_c = solve_viscous_newton_cont(
                    the_op, a_t, float(reynolds), *st, **kw)
                if bool(res_c.converged):
                    return res_c

        return solve_viscous(the_op, float(alpha), float(reynolds), **kw)

    # Strategies 1 and 2: viscous on clean then smoothed geometry.
    for strategy, the_op in ((1, op), (2, None)):
        if strategy == 2:
            xs, ys = smooth_geometry(xp, yp)
            the_op = build_operator(panel_geometry(xs, ys))
        res = solve_best(the_op)
        if bool(res.converged):
            return AnalysisResult(
                cp_x=cp_x_of(the_op),
                cp_values=[float(v) for v in _host(res.cp)],
                coefficients=coeffs(res.cl, res.cd, res.cdp, res.cm,
                                    "viscous"),
                bl_data=_bl_payload(res),
                mode="viscous",
                strategy=strategy,
                converged=True,
                sep_fraction=float(res.sep_fraction),
            )

    # Strategy 3: inviscid fallback (no BL data; reference main.py:315-323).
    sol = inviscid_program(op, float(alpha))
    return AnalysisResult(
        cp_x=cp_x_of(op),
        cp_values=[float(v) for v in _host(sol.cp)],
        coefficients=coeffs(sol.cl, 0.0, 0.0, sol.cm, "inviscid"),
        bl_data=None,
        mode="inviscid",
        strategy=3,
        converged=True,
    )
