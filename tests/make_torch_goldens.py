"""Write ``tests/golden/torch_viscous.json``: reference outputs of the JAX
package for the checks of ``airfoil_tpu_torch`` that run where JAX is not
installed (``chip_smoke.py`` on the GPU machine).

    JAX_PLATFORMS=cpu python tests/make_torch_goldens.py

Runs the JAX package on the CPU. The file holds:

- ``inviscid``: CL and Cm of ``solve_inviscid`` for NACA 0012, 2412 and
  4412 at 160 panels, alpha 0 and 5;
- ``viscous``: ``solve_viscous`` at its default configuration (160 panels,
  80 stations, 24 wake stations, 24 coupling passes) at the points
  ``chip_smoke.py`` runs: CL, CD, CDp, Cm, converged, the transition x of
  each side and the separated fraction;
- ``tripped``: the same at the points ``chip_smoke.py`` runs with both
  sides tripped at x = ``TRIP_X``.

The direct coupling iteration lands in one of several transition basins
where a transition sits between two stations, and which one it lands in
turns on float32 rounding (a one-ulp change of an input moves CD there by
up to ~15% and a transition by a station). So each viscous point also
carries the reference's own rounding ensemble: the nominal solve and the
same solve at Reynolds numbers Re (1 + k 2^-23) and at angles alpha +
k 1e-5 degrees, k = -16..16 (k != 0), summarised as the range of each
output over the ensemble and the set of ``converged`` values. A port that
reproduces the reference lands inside that range, give or take the
comparison bars.

Tripped near the leading edge, a side has no laminar run to separate, so
the knife edge does not arise: there the ensemble spans a few 1e-5 in CL
and less elsewhere, and a port is held to the nominal run itself.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np

from airfoil_tpu.inviscid import build_operator, solve_inviscid
from airfoil_tpu.models import naca4
from airfoil_tpu.paneling import panel_geometry, repanel
from airfoil_tpu.viscous import solve_viscous

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_viscous.json")
N_PANELS = 160
COORD_POINTS = 100          # naca4(m, p, t, 100), as tests/test_viscous.py
INVISCID = [(code, alpha) for code in ("0012", "2412", "4412")
            for alpha in (0.0, 5.0)]
# (section, alpha, Re): the points of chip_smoke.py's viscous phase.
VISCOUS = [("2412", 0.0, 1e6), ("2412", 5.0, 1e6), ("0012", 0.0, 1e6),
           ("0012", 4.0, 1e6), ("0012", -4.0, 1e6), ("0012", 16.0, 1e6)]
# Both sides tripped at TRIP_X (x_forced_transition): the deterministic
# points, held to the nominal run.
TRIP_X = 0.05
TRIPPED = [("2412", 0.0, 1e6), ("2412", 5.0, 1e6), ("0012", 4.0, 1e6)]
ENSEMBLE_K = [k for k in range(-16, 17) if k]
FIELDS = ("cl", "cd", "cdp", "cm", "xtr_upper", "xtr_lower", "sep_fraction")


def operator_for(code: str):
    coords = naca4(int(code[0]), int(code[1]), int(code[2:]), COORD_POINTS)
    return build_operator(panel_geometry(*repanel(coords, N_PANELS)))


def viscous_record(r) -> dict:
    return {"cl": float(r.cl), "cd": float(r.cd), "cdp": float(r.cdp),
            "cm": float(r.cm), "converged": bool(r.converged),
            "xtr_upper": float(r.upper.x_transition),
            "xtr_lower": float(r.lower.x_transition),
            "sep_fraction": float(r.sep_fraction)}


def ensemble_inputs(alpha: float, re: float) -> list:
    """The rounding ensemble's (alpha, Re) pairs, the nominal point
    first."""
    re32 = np.float32(re)
    return ([(alpha, float(re32))]
            + [(alpha, float(re32 * (1.0 + k * 2.0 ** -23)))
               for k in ENSEMBLE_K]
            + [(alpha + k * 1e-5, float(re32)) for k in ENSEMBLE_K])


def viscous_point(op, alpha: float, re: float, **kw) -> dict:
    """The nominal solve's record with its rounding ensemble's ranges;
    ``kw`` goes to ``solve_viscous``."""
    rec = viscous_record(solve_viscous(op, alpha, re, **kw))
    members = [rec] + [viscous_record(solve_viscous(op, a, r, **kw))
                       for a, r in ensemble_inputs(alpha, re)[1:]]
    rec["ensemble"] = {f: [min(m[f] for m in members),
                           max(m[f] for m in members)] for f in FIELDS}
    rec["ensemble"]["converged"] = sorted({m["converged"] for m in members})
    return rec


def main() -> int:
    # Before the first computation, which initialises the backends
    # (tests/test_torch_goldens.py imports this module under pytest's own
    # JAX setup).
    jax.config.update("jax_platforms", "cpu")
    ops = {code: operator_for(code) for code in ("0012", "2412", "4412")}
    inviscid = []
    for code, alpha in INVISCID:
        sol = solve_inviscid(ops[code], alpha)
        inviscid.append({"naca": code, "alpha": alpha, "cl": float(sol.cl),
                         "cm": float(sol.cm)})
    viscous = []
    for code, alpha, re in VISCOUS:
        rec = {"naca": code, "alpha": alpha, "re": re,
               **viscous_point(ops[code], alpha, re)}
        viscous.append(rec)
        print(json.dumps(rec), flush=True)
    tripped = []
    for code, alpha, re in TRIPPED:
        rec = {"naca": code, "alpha": alpha, "re": re,
               **viscous_point(ops[code], alpha, re,
                               x_forced_transition=TRIP_X)}
        tripped.append(rec)
        print(json.dumps(rec), flush=True)
    doc = {
        "generated_by": "tests/make_torch_goldens.py",
        "jax_version": jax.__version__,
        "geometry": f"airfoil_tpu.models.naca4(m, p, t, {COORD_POINTS}), "
                    f"repanel(coords, {N_PANELS}) (airfoil spacing)",
        "viscous_config": {"n_stations": 80, "n_wake": 24,
                           "coupling_iters": 24, "n_crit": 9.0,
                           "x_forced_transition": 1.0, "relax": 0.3},
        "ensemble_k": ENSEMBLE_K,
        "inviscid": inviscid,
        "viscous": viscous,
        "trip_x": TRIP_X,
        "tripped": tripped,
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
