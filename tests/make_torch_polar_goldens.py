"""Write ``tests/golden/torch_polar.json``: reference outputs of the JAX
package's polar sweep and batch analysis, for the checks of
``airfoil_tpu_torch`` that run where JAX is not installed (``chip_smoke.py``
on the GPU machine) and for the CPU test of the whole port polar.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_polar_goldens.py

Runs the JAX package on the CPU (~100 min; it rewrites the file after every
section). The file holds:

- ``polar``: ``solve_polar(naca4(2, 4, 12, 80), POLAR_ALPHAS, 1e6)`` at
  the reference's full width (160 panels, 96 stations a side, 20 wake
  stations): the slow tier's ``polar2412``;
- ``batch``: ``solve_batch`` of ``naca4(2, 4, 12, 80)`` and
  ``naca4(0, 0, 12, 70)`` at alpha 2, Re 1e6 (``tests/test_polar.py``'s
  ``TestBatch``).

Each polar point carries a rounding ensemble of 33 members: the nominal
run and the same run at Reynolds numbers Re (1 + k 2^-23) and at angles
alpha + k 1e-5 degrees, k in ``ENSEMBLE_K`` (-8..8; with k = -2..2 the
range left out a basin the card landed in: at alpha 4 a late transition
with CD 0.0052); each batch lane one of 257 (``BATCH_ENSEMBLE_K``,
-64..64: NACA 2412 at alpha 2 is a strong knife edge, whose converged
members' CD spread 0.0040-0.0072 over 65 members and 0.0040-0.0078 over
257, where the card landed at 0.0077), as every member's
record (``members``, the nominal one first) and the range of each output
(``ensemble``). Which transition basin a Newton solve lands in turns on
float32 rounding, so a check holds a port's answer to the range of the
members that share its verdict (``mode`` and ``converged``). The polar
also keeps the nominal run's per-point pass (``points_pass``: the
``_points_kernel`` answer of every padded lane, with its final state
``zz``, ``xtr_u``, ``xtr_l``), the batch its lanes' (``points_pass``): a
lane-batched solve started from those states must return those answers,
whatever basin rounding would pick from the warm start.

A polar at a reduced shape (32 stations a side) is not kept: there the
per-point solves land in rounding-dependent basins even between the
reference's own one-point and lane-batched solves of the same point, and
the port's polar takes minutes on a CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_polar.json")
RE = 1e6
POLAR_NACA = (2, 4, 12, 80)
POLAR_ALPHAS = [-2.0, 0.0, 2.0, 4.0, 6.0]
BATCH = [(2, 4, 12, 80), (0, 0, 12, 70)]
BATCH_ALPHA = 2.0
ENSEMBLE_K = [k for k in range(-8, 9) if k]
# A batch lane is one point's solve, at a point whose basins are rare
# enough to need four times the single-point Newton goldens' 65 members.
BATCH_ENSEMBLE_K = [k for k in range(-64, 65) if k]
FIELDS = ("cl", "cd", "cdp", "cm", "xtr_upper", "xtr_lower", "sep_fraction")
MERGED = FIELDS[:4] + ("converged",) + FIELDS[4:]


def ensemble_inputs(ks=ENSEMBLE_K):
    """(alpha shift, Re) of every member, the nominal one first."""
    re32 = np.float32(RE)
    return ([(0.0, float(re32))]
            + [(0.0, float(re32 * (1.0 + k * 2.0 ** -23))) for k in ks]
            + [(k * 1e-5, float(re32)) for k in ks])


def summarise(members: list, flags=("converged",)) -> dict:
    rec = dict(members[0])
    rec["ensemble"] = {f: [min(m[f] for m in members),
                           max(m[f] for m in members)] for f in FIELDS}
    for flag in flags:
        rec["ensemble"][flag] = sorted({m[flag] for m in members})
    rec["members"] = members
    return rec


def polar_records(res) -> list:
    return [{"alpha": float(res.alpha[i]), "cl": float(res.cl[i]),
             "cd": float(res.cd[i]), "cdp": float(res.cdp[i]),
             "cm": float(res.cm[i]), "mode": int(res.mode[i]),
             "converged": bool(res.converged[i]),
             "xtr_upper": float(res.xtr_upper[i]),
             "xtr_lower": float(res.xtr_lower[i]),
             "sep_fraction": float(res.sep_fraction[i])}
            for i in range(len(res.cl))]


def pass_records(out, alphas) -> list:
    """A per-point pass's answer ((merged), (newton_converged, (zz, xtr_u,
    xtr_l))), lane by lane, each lane with its final state."""
    merged, (nok, (zz, xtr_u, xtr_l)) = out
    recs = []
    for i in range(len(alphas)):
        rec = {f: (bool(v[i]) if f == "converged" else float(v[i]))
               for f, v in zip(MERGED, merged)}
        rec["alpha"] = float(alphas[i])
        rec["newton_converged"] = bool(nok[i])
        rec["state"] = {"zz": [float(v) for v in np.asarray(zz[i])],
                        "xtr_u": float(xtr_u[i]), "xtr_l": float(xtr_l[i])}
        recs.append(rec)
    return recs


def points_pass(coords, alphas) -> list:
    """The nominal polar's per-point pass, lane by lane (padded bucket)."""
    import jax.numpy as jnp

    from airfoil_tpu.polar import sweep as S

    c = S._pad_coords(jnp.asarray(coords, jnp.float32))
    a = np.asarray(alphas, np.float32)
    pad = S._bucket_size(len(a)) - len(a)
    a = np.concatenate([a, np.repeat(a[-1:], pad)])
    op, _xp, _yp = S._op_kernel(c, 160)
    return pass_records(S._points_kernel(
        op, jnp.asarray(a), jnp.full(a.shape, RE, jnp.float32)), a)


def batch_pass(coords) -> list:
    """The nominal batch lane by lane, with each lane's final state:
    ``solve_batch``'s kernel (its loops are of one length already, and
    alpha and Re are traced as there: as constants they round otherwise)
    with ``solve_polar_point``'s state kept."""
    import jax.numpy as jnp

    from airfoil_tpu.inviscid import build_operator
    from airfoil_tpu.paneling import panel_geometry, repanel
    from airfoil_tpu.viscous.newton import solve_polar_point

    @jax.jit
    def kernel(coords_b, alpha, reynolds):
        def one(c):
            op = build_operator(panel_geometry(*repanel(c, 160)))
            return solve_polar_point(op, alpha, reynolds, n_stations=96)

        return jax.vmap(one)(coords_b)

    out = kernel(jnp.asarray(np.stack(coords), jnp.float32),
                 float(BATCH_ALPHA), float(RE))
    return pass_records(out, [BATCH_ALPHA] * len(coords))


def polar_section() -> dict:
    from airfoil_tpu.models import naca4
    from airfoil_tpu.polar import sweep as S

    coords = np.asarray(naca4(*POLAR_NACA), np.float32)
    alphas = np.asarray(POLAR_ALPHAS, np.float32)
    runs = [polar_records(S.solve_polar(coords, alphas + np.float32(da), re))
            for da, re in ensemble_inputs()]
    points = [summarise([run[i] for run in runs], ("converged", "mode"))
              for i in range(len(alphas))]
    return {"naca": list(POLAR_NACA), "alphas": POLAR_ALPHAS, "re": RE,
            "n_panels": 160, "points": points,
            "points_pass": points_pass(coords, alphas)}


def batch_section() -> dict:
    from airfoil_tpu.models import naca4
    from airfoil_tpu.polar.batch import solve_batch

    coords = [np.asarray(naca4(*c), np.float32) for c in BATCH]
    # solve_batch's host resampling of a loop to the first one's length.
    n = len(coords[0])
    same_length = [c if len(c) == n else np.stack(
        [np.interp(np.linspace(0.0, 1.0, n), np.linspace(0.0, 1.0, len(c)),
                   c[:, j]) for j in (0, 1)], axis=1).astype(np.float32)
        for c in coords]
    runs = []
    for da, re in ensemble_inputs(BATCH_ENSEMBLE_K):
        r = solve_batch(coords, re, BATCH_ALPHA + da)
        runs.append([{f: (bool(getattr(r, g)[i]) if f == "converged"
                          else float(getattr(r, g)[i]))
                      for f, g in zip(MERGED, r._fields)}
                     for i in range(len(coords))])
    lanes = [summarise([run[i] for run in runs]) for i in range(len(coords))]
    return {"files": [list(c) for c in BATCH], "alpha": BATCH_ALPHA,
            "re": RE, "ensemble_k": BATCH_ENSEMBLE_K, "lanes": lanes,
            "points_pass": batch_pass(same_length)}


def write(doc: dict) -> None:
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    doc = {"generated_by": "tests/make_torch_polar_goldens.py",
           "jax_version": jax.__version__,
           "geometry": "airfoil_tpu.models.naca4(m, p, t, n), solve_polar's "
                       "own paneling (160 panels)",
           "ensemble_k": ENSEMBLE_K}

    def log(msg):
        print(f"[{time.perf_counter() - t0:7.1f} s] {msg}", flush=True)

    doc["polar"] = polar_section()
    log("polar: " + json.dumps([{k: p[k] for k in MERGED + ("mode",)}
                                for p in doc["polar"]["points"]]))
    write(doc)
    doc["batch"] = batch_section()
    log("batch: " + json.dumps([{k: p[k] for k in MERGED}
                                for p in doc["batch"]["lanes"]]))
    write(doc)
    log(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
