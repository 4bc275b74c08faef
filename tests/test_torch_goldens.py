"""``tests/golden/torch_viscous.json`` against the JAX package, so the file
``chip_smoke.py`` holds the port to on the GPU (where there is no JAX)
cannot go stale.

- The file covers exactly the points ``tests/make_torch_goldens.py``
  lists, and ``chip_smoke.py`` builds the geometry the goldens came from.
- The inviscid goldens are recomputed and held at chip_smoke's bar (CL and
  Cm within rtol 1e-4, atol 1e-5).
- One viscous point at the default configuration (NACA 2412, alpha 0,
  Re 1e6: 160 panels, 80 stations, 24 wake stations, 24 passes) re-runs
  through JAX and is held to the golden at the port's bars: CL within
  0.025, CD within 5 %, Cm within 0.01, x_transition within 0.05 c,
  ``converged`` equal, and inside the golden ensemble's range.
- The tripped points (both sides tripped at x 0.05) are deterministic:
  their ensembles span under 1 % of each bar, with one ``converged``
  value. One of them (NACA 2412, alpha 5) re-runs through JAX and is held
  to the golden at the same bars.
- ``tests/golden/torch_newton.json`` (``tests/make_torch_newton_goldens.py``)
  covers exactly the points, shapes, alphas and upload its script lists,
  every solve record with its whole rounding ensemble, and its upload is
  the file ``chip_smoke.py``'s served session sends.
"""

import json

import numpy as np
import pytest

import chip_smoke
import make_torch_goldens as mg
import make_torch_newton_goldens as mn
from airfoil_tpu.inviscid import solve_inviscid
from airfoil_tpu.models import naca4

with open(mg.OUT) as fh:
    GOLDEN = json.load(fh)
with open(mn.OUT) as fh:
    NEWTON = json.load(fh)


def test_goldens_cover_the_listed_points():
    assert [(g["naca"], g["alpha"]) for g in GOLDEN["inviscid"]] \
        == mg.INVISCID
    assert [(g["naca"], g["alpha"], g["re"]) for g in GOLDEN["viscous"]] \
        == mg.VISCOUS
    assert GOLDEN["ensemble_k"] == mg.ENSEMBLE_K
    assert [(g["naca"], g["alpha"], g["re"]) for g in GOLDEN["tripped"]] \
        == mg.TRIPPED
    assert GOLDEN["trip_x"] == mg.TRIP_X
    for g in GOLDEN["viscous"] + GOLDEN["tripped"]:
        assert set(g["ensemble"]) == set(mg.FIELDS) | {"converged"}


@pytest.mark.parametrize("i", range(len(mg.TRIPPED)))
def test_tripped_goldens_are_deterministic(i):
    g = GOLDEN["tripped"][i]
    for f, (abs_bar, rel_bar) in chip_smoke.VISCOUS_BARS.items():
        lo, hi = g["ensemble"][f]
        assert hi - lo <= 0.01 * (abs_bar + rel_bar * abs(g[f])), f
    assert g["ensemble"]["converged"] == [g["converged"]]


@pytest.mark.parametrize("code", ["0012", "2412", "4412"])
def test_chip_smoke_geometry_is_the_goldens(code):
    m, p, t = int(code[0]), int(code[1]), int(code[2:])
    np.testing.assert_allclose(chip_smoke.naca4_coords(m, p, t, 100),
                               naca4(m, p, t, mg.COORD_POINTS),
                               rtol=0, atol=1e-12)
    assert chip_smoke.N_PANELS == mg.N_PANELS


@pytest.mark.parametrize("code", ["0012", "2412", "4412"])
def test_inviscid_goldens_are_current(code):
    op = mg.operator_for(code)
    for g in GOLDEN["inviscid"]:
        if g["naca"] != code:
            continue
        sol = solve_inviscid(op, g["alpha"])
        for f in ("cl", "cm"):
            assert abs(float(getattr(sol, f)) - g[f]) \
                <= 1e-4 * abs(g[f]) + 1e-5, (code, g["alpha"], f)


def test_viscous_golden_point_is_current():
    g = next(v for v in GOLDEN["viscous"]
             if (v["naca"], v["alpha"]) == ("2412", 0.0))
    rec = mg.viscous_record(
        mg.solve_viscous(mg.operator_for("2412"), g["alpha"], g["re"]))
    assert abs(rec["cl"] - g["cl"]) <= 0.025
    assert abs(rec["cd"] - g["cd"]) <= 0.05 * abs(g["cd"])
    assert abs(rec["cm"] - g["cm"]) <= 0.01
    for f in ("xtr_upper", "xtr_lower"):
        assert abs(rec[f] - g[f]) <= 0.05, f
    assert rec["converged"] == g["converged"]
    for f, (abs_bar, rel_bar) in chip_smoke.VISCOUS_BARS.items():
        lo, hi = g["ensemble"][f]
        assert (lo - abs_bar - rel_bar * abs(lo) <= rec[f]
                <= hi + abs_bar + rel_bar * abs(hi)), f


def test_tripped_golden_point_is_current():
    g = next(v for v in GOLDEN["tripped"]
             if (v["naca"], v["alpha"]) == ("2412", 5.0))
    rec = mg.viscous_record(mg.solve_viscous(
        mg.operator_for("2412"), g["alpha"], g["re"],
        x_forced_transition=GOLDEN["trip_x"]))
    for f, (abs_bar, rel_bar) in chip_smoke.VISCOUS_BARS.items():
        assert abs(rec[f] - g[f]) <= abs_bar + rel_bar * abs(g[f]), f
    assert rec["converged"] == g["converged"]


def _has_ensemble(rec: dict, flags=("converged",)) -> bool:
    members = rec["members"]
    return (len(members) == 1 + 2 * len(mn.ENSEMBLE_K)
            and members[0] == {k: rec[k] for k in members[0]}
            and set(rec["ensemble"]) == set(mn.FIELDS) | set(flags)
            and all(rec["ensemble"][f] == [min(m[f] for m in members),
                                           max(m[f] for m in members)]
                    for f in mn.FIELDS))


def test_newton_goldens_cover_the_listed_points():
    assert NEWTON["ensemble_k"] == mn.ENSEMBLE_K
    assert NEWTON["reduced_config"] == mn.REDUCED
    for key, points in (("newton", mn.NEWTON),
                        ("newton_reduced", mn.NEWTON_REDUCED)):
        assert [(g["naca"], g["alpha"], g["re"]) for g in NEWTON[key]] == \
            [(code, alpha, mn.RE) for code, alpha in points]
        assert all(_has_ensemble(g) for g in NEWTON[key]), key
    for name, shape in (("default", {}), ("reduced", mn.REDUCED)):
        c = NEWTON["continuation"][name]
        assert (c["shape"], c["donor_alpha"], c["cont_alpha"]) == \
            (shape, mn.DONOR_ALPHA, mn.CONT_ALPHA)
        assert _has_ensemble(c["donor"], ("converged", "newton_converged"))
        assert _has_ensemble(c["solve_viscous_newton_cont"])
        assert _has_ensemble(c["solve_polar_point_cont"],
                             ("converged", "newton_converged"))
        n = 96 if name == "default" else shape["n_stations"]
        n_w = 20 if name == "default" else shape["n_wake"]
        assert len(c["donor"]["state"]["zz"]) == 4 * (2 * n + n_w)
    assert [a["alpha"] for a in NEWTON["analyze"]] == mn.ANALYZE
    for a in NEWTON["analyze"]:
        assert a["coords"] == mn.ANALYZE_COORDS and a["calls"]
        assert len(a["cp_values"]) == len(a["cp_x"]) == mn.N_PANELS
        assert ("ensemble" in a) == (a["mode"] == "viscous")
    up = NEWTON["upload"]
    assert (up["reynolds"], up["alpha"]) == (mn.UPLOAD["reynolds"],
                                             mn.UPLOAD["alpha"])
    assert up["status"] == 200 and up["reply"]["success"] is True
    assert set(up["ensemble"]) >= {"cl", "cd", "cm", "mode", "strategy"}


def test_newton_golden_upload_is_chip_smokes_file():
    """The upload golden's file is the NACA 2412 that ``chip_smoke.py``'s
    served session writes (the port's ``naca4``, 60 points a side)."""
    dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                      for x, y in chip_smoke.naca4_coords())
    assert NEWTON["upload"]["dat"] == dat == mn.upload_dat()
