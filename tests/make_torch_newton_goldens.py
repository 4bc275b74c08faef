"""Write ``tests/golden/torch_newton.json``: reference outputs of the JAX
package's simultaneous-Newton path, for the checks of ``airfoil_tpu_torch``
that run where JAX is not installed (``chip_smoke.py`` on the GPU machine)
and for the CPU tests, which would take minutes a point to run the JAX
solve live.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_newton_goldens.py

Runs the JAX package on the CPU (~30 min). The file holds:

- ``newton``: ``solve_viscous_newton`` at its defaults (160 panels, 96
  stations a side, 20 wake stations, 8 warm passes, 4 rounds of 12 LM
  iterations) at the ``NEWTON`` points: CL, CD, CDp, Cm, ``converged``,
  both transitions and the separated fraction;
- ``newton_reduced``: the same at ``REDUCED`` (32 stations, 8 wake
  stations, 2 warm passes), the shape the CPU tests run;
- ``continuation``: at both shapes, ``solve_polar_point`` at NACA 2412
  alpha ``DONOR_ALPHA`` with its donor state (zz, x_tr upper, x_tr lower),
  then ``solve_viscous_newton_cont`` and ``solve_polar_point_cont`` from
  that state to alpha ``CONT_ALPHA``;
- ``analyze``: ``analyze_airfoil(naca4(2, 4, 12, 80), 1e6, alpha)`` at the
  ``ANALYZE`` alphas: the whole result and the solver calls it made (name,
  alpha, converged), in order;
- ``upload``: ``handle_upload`` of ``upload_dat()`` (NACA 2412, 60 points a
  side) at Re 1e6, alpha 5: the whole JSON reply.

Every solve record carries the reference's rounding ensemble, as
``tests/make_torch_goldens.py`` makes it: the nominal solve and the same
solve at Reynolds numbers Re (1 + k 2^-23) and at angles alpha + k 1e-5
degrees, k = -16..16 (k != 0), as the range of each output and the set of
``converged`` values, and every member's record (the continuation solves
keep the one donor state). The analyses of the viscous alpha and of the
upload carry the ranges of their coefficients, modes and strategies.
The Newton solve lands in one of several transition basins at some points,
and which one turns on float32 rounding; a port that reproduces the
reference lands inside the range, give or take the comparison bars.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import jax
import numpy as np

from airfoil_tpu.inviscid import build_operator
from airfoil_tpu.models import naca4
from airfoil_tpu.paneling import panel_geometry, repanel
from airfoil_tpu.viscous import newton

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_newton.json")
N_PANELS = 160
COORD_POINTS = 100          # naca4(m, p, t, 100), as tests/test_newton.py
RE = 1e6
NEWTON = [("2412", 0.0), ("2412", 4.0), ("2412", 5.0), ("0012", 0.0),
          ("0012", 4.0)]
REDUCED = {"n_stations": 32, "n_wake": 8, "warm_iters": 2}
NEWTON_REDUCED = [("2412", 4.0), ("0012", 0.0), ("2412", 0.0)]
DONOR_ALPHA, CONT_ALPHA = 8.0, 10.0
ANALYZE = [4.0, 19.0]
ANALYZE_COORDS = 80         # naca4(2, 4, 12, 80), as tests/test_polar.py
UPLOAD = {"reynolds": 1e6, "alpha": 5.0}
ENSEMBLE_K = [k for k in range(-16, 17) if k]
FIELDS = ("cl", "cd", "cdp", "cm", "xtr_upper", "xtr_lower", "sep_fraction")
MERGED = FIELDS[:4] + ("converged",) + FIELDS[4:]


def upload_dat() -> str:
    """The uploaded file: NACA 2412, 60 points a side, as chip_smoke's
    served session writes it."""
    return "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                     for x, y in naca4(2, 4, 12, 60))


def operator_for(code: str):
    coords = naca4(int(code[0]), int(code[1]), int(code[2:]), COORD_POINTS)
    return build_operator(panel_geometry(*repanel(coords, N_PANELS)))


def ensemble_inputs(alpha: float, re: float) -> list:
    """The rounding ensemble's (alpha, Re) pairs, the nominal point first
    (a copy of ``make_torch_goldens.ensemble_inputs``)."""
    re32 = np.float32(re)
    return ([(alpha, float(re32))]
            + [(alpha, float(re32 * (1.0 + k * 2.0 ** -23)))
               for k in ENSEMBLE_K]
            + [(alpha + k * 1e-5, float(re32)) for k in ENSEMBLE_K])


def result_record(r) -> dict:
    return {"cl": float(r.cl), "cd": float(r.cd), "cdp": float(r.cdp),
            "cm": float(r.cm), "converged": bool(r.converged),
            "xtr_upper": float(r.upper.x_transition),
            "xtr_lower": float(r.lower.x_transition),
            "sep_fraction": float(r.sep_fraction)}


def merged_record(out) -> dict:
    merged, (nok, _state) = out
    rec = {f: (bool(v) if f == "converged" else float(v))
           for f, v in zip(MERGED, merged)}
    rec["newton_converged"] = bool(nok)
    return rec


def with_ensemble(solve, record, alpha: float, re: float) -> dict:
    """``record(solve(alpha, re))``, its rounding ensemble's ranges, and
    every member's record (``members``, the nominal one first), so that a
    check can take the range over the members of one ``converged``
    value."""
    members = [record(solve(a, r)) for a, r in ensemble_inputs(alpha, re)]
    rec = dict(members[0])
    rec["ensemble"] = {f: [min(m[f] for m in members),
                           max(m[f] for m in members)] for f in FIELDS}
    for flag in ("converged", "newton_converged"):
        if flag in rec:
            rec["ensemble"][flag] = sorted({m[flag] for m in members})
    rec["members"] = members
    return rec


def continuation(op, shape: dict) -> dict:
    """Donor at DONOR_ALPHA, then both continuation solves to CONT_ALPHA
    from its state; ``shape`` sets the station counts (and the donor's
    warm passes)."""
    cont_shape = {k: v for k, v in shape.items() if k != "warm_iters"}
    donor_out = newton.solve_polar_point(op, DONOR_ALPHA, RE, **shape)
    zz, xtr_u, xtr_l = donor_out[1][1]
    state = (zz, xtr_u, xtr_l)
    donor = with_ensemble(
        lambda a, r: newton.solve_polar_point(op, a, r, **shape),
        merged_record, DONOR_ALPHA, RE)
    donor["state"] = {"zz": [float(v) for v in np.asarray(zz)],
                      "xtr_u": float(xtr_u), "xtr_l": float(xtr_l)}
    cont = with_ensemble(
        lambda a, r: newton.solve_viscous_newton_cont(op, a, r, *state,
                                                      **cont_shape),
        result_record, CONT_ALPHA, RE)
    cont_point = with_ensemble(
        lambda a, r: newton.solve_polar_point_cont(op, a, r, *state,
                                                   **cont_shape),
        merged_record, CONT_ALPHA, RE)
    return {"naca": "2412", "re": RE, "shape": shape,
            "donor_alpha": DONOR_ALPHA, "cont_alpha": CONT_ALPHA,
            "donor": donor, "solve_viscous_newton_cont": cont,
            "solve_polar_point_cont": cont_point}


def analysis_record(r) -> dict:
    return {"coefficients": r.coefficients, "mode": r.mode,
            "strategy": r.strategy, "converged": r.converged,
            "sep_fraction": r.sep_fraction, "cp_x": r.cp_x,
            "cp_values": r.cp_values, "bl_data": r.bl_data}


def recorded_calls(fn):
    """Run ``fn()`` with the solvers ``analyze_airfoil`` reaches wrapped:
    returns (its result, [(solver, alpha, converged), ...])."""
    from airfoil_tpu.polar import analyze as an

    calls = []
    patched = {(newton, name): getattr(newton, name)
               for name in ("solve_polar_point", "solve_polar_point_cont",
                            "solve_viscous_newton_cont")}
    patched[an, "solve_viscous_newton"] = an.solve_viscous_newton
    patched[an, "solve_viscous"] = an.solve_viscous

    def wrap(name, f):
        def run(op, alpha, *args, **kwargs):
            out = f(op, alpha, *args, **kwargs)
            conv = out[1][0] if isinstance(out, tuple) and len(out) == 2 \
                else out.converged
            calls.append([name, float(alpha), bool(conv)])
            return out
        return run

    for (mod, name), f in patched.items():
        setattr(mod, name, wrap(name, f))
    try:
        return fn(), calls
    finally:
        for (mod, name), f in patched.items():
            setattr(mod, name, f)


def analyze_ensemble(coords, alpha: float, re: float) -> dict:
    from airfoil_tpu.polar import analyze_airfoil

    members = []
    for a, r in ensemble_inputs(alpha, re):
        res = analyze_airfoil(coords, r, a)
        c = res.coefficients
        members.append({"cl": c["CL"], "cd": c["CD"], "cdp": c["CDp"],
                        "cm": c["Cm"], "mode": res.mode,
                        "strategy": res.strategy})
    ens = {f: [min(m[f] for m in members), max(m[f] for m in members)]
           for f in ("cl", "cd", "cdp", "cm")}
    for f in ("mode", "strategy"):
        ens[f] = sorted({m[f] for m in members})
    return ens


def write(doc: dict) -> None:
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    # The upload handler logs each run and counts analyses: keep both away
    # from the user's files (the counter's path is read at import).
    os.environ["AIRFOIL_TPU_RUN_LOG_DIR"] = ""
    os.environ["AIRFOIL_TPU_STATS_PATH"] = os.path.join(tempfile.mkdtemp(),
                                                        "stats.db")
    from airfoil_tpu.api.handlers import handle_upload
    from airfoil_tpu.polar import analyze_airfoil

    t0 = time.perf_counter()
    ops = {code: operator_for(code) for code in ("0012", "2412")}
    doc = {
        "generated_by": "tests/make_torch_newton_goldens.py",
        "jax_version": jax.__version__,
        "geometry": f"airfoil_tpu.models.naca4(m, p, t, {COORD_POINTS}), "
                    f"repanel(coords, {N_PANELS}) (airfoil spacing)",
        "re": RE, "ensemble_k": ENSEMBLE_K,
        "reduced_config": REDUCED,
    }

    def log(msg):
        print(f"[{time.perf_counter() - t0:7.1f} s] {msg}", flush=True)

    for key, points, shape in (("newton_reduced", NEWTON_REDUCED, REDUCED),
                               ("newton", NEWTON, {})):
        doc[key] = []
        for code, alpha in points:
            rec = with_ensemble(
                lambda a, r: newton.solve_viscous_newton(ops[code], a, r,
                                                         **shape),
                result_record, alpha, RE)
            doc[key].append({"naca": code, "alpha": alpha, "re": RE, **rec})
            log(f"{key} {code} {alpha}: {json.dumps(doc[key][-1])}")
            write(doc)

    doc["continuation"] = {}
    for name, shape in (("reduced", REDUCED), ("default", {})):
        doc["continuation"][name] = continuation(ops["2412"], shape)
        log(f"continuation {name}: " + json.dumps(
            {k: v for k, v in doc["continuation"][name].items()
             if k != "donor"}))
        write(doc)

    coords = naca4(2, 4, 12, ANALYZE_COORDS)
    doc["analyze"] = []
    for alpha in ANALYZE:
        res, calls = recorded_calls(lambda: analyze_airfoil(coords, RE,
                                                            alpha))
        rec = {"alpha": alpha, "re": RE, "coords": ANALYZE_COORDS,
               **analysis_record(res), "calls": calls}
        if res.mode == "viscous":
            rec["ensemble"] = analyze_ensemble(coords, alpha, RE)
        doc["analyze"].append(rec)
        log(f"analyze {alpha}: {res.coefficients} strategy {res.strategy} "
            f"calls {calls} {rec.get('ensemble')}")
        write(doc)

    dat = upload_dat()
    (status, reply), calls = recorded_calls(lambda: handle_upload(
        "naca2412.dat", dat.encode(), UPLOAD["reynolds"], UPLOAD["alpha"]))
    from airfoil_tpu.api.handlers import parse_upload
    parsed, _ = parse_upload("naca2412.dat", dat.encode())
    doc["upload"] = {"filename": "naca2412.dat", "dat": dat, **UPLOAD,
                     "status": status, "reply": reply, "calls": calls,
                     "ensemble": analyze_ensemble(
                         parsed, UPLOAD["alpha"], UPLOAD["reynolds"])}
    log(f"upload: {status} {reply['coefficients']} calls {calls} "
        f"{doc['upload']['ensemble']}")
    write(doc)
    log(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
