"""The port's analytic shapes (``airfoil_tpu_torch.models``) against the
JAX package's, and the port's panel solver against the exact Joukowski
solution.

``clark_y``, every ``SHAPES`` entry, ``joukowski`` and ``joukowski_exact``
are NumPy copies: their outputs must equal the reference's array for array
(exact). The port's ``solve_inviscid`` on the CPU, at 160 panels from its
own ``repanel`` of its own ``joukowski``, is held to the closed-form
answer at the bars of ``tests/test_inviscid.py``'s ``TestExactJoukowski``
(CL within 1.5 %, |CL| < 5e-3 at zero lift, Cp rms < 0.035 for x < 0.98),
and its CL and Cm to the JAX solve within 1e-4 relative + 1e-5
(``chip_smoke.py``'s inviscid bar) on the same nodes: either package's
``repanel`` of the same loop, fed to both solvers. The two packages' nodes
differ by up to 6e-7 (the arc length's float32 rounding), and at the cusp
that moves both solvers' CL alike by up to 2.8e-4 (case (-0.12, 0.06, 8)),
so each solve is held to the other's on the nodes it was given.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu.inviscid import build_operator as jbuild
from airfoil_tpu.inviscid import solve_inviscid as jsolve
from airfoil_tpu.models import SHAPES as REF_SHAPES
from airfoil_tpu.models import clark_y as ref_clark_y
from airfoil_tpu.models import joukowski as ref_joukowski
from airfoil_tpu.models import joukowski_exact as ref_joukowski_exact
from airfoil_tpu.paneling import panel_geometry as jgeom
from airfoil_tpu.paneling import repanel as jrepanel
from airfoil_tpu_torch.inviscid import build_operator, solve_inviscid
from airfoil_tpu_torch.models import SHAPES, clark_y, joukowski, \
    joukowski_exact
from airfoil_tpu_torch.paneling import panel_geometry, repanel

# (mu_x, mu_y, alpha): tests/test_inviscid.py's TestExactJoukowski cases.
EXACT_CASES = [(-0.08, 0.0, 0.0), (-0.08, 0.0, 5.0),
               (-0.08, 0.04, 4.0), (-0.12, 0.06, 8.0)]


def _draws(seed: int):
    """Seeded Joukowski parameters: circle centre, points, spacing, alpha,
    the exact solution's points and trailing-edge margin."""
    rng = np.random.default_rng(seed)
    return (float(rng.uniform(-0.15, -0.03)), float(rng.uniform(0.0, 0.08)),
            int(rng.integers(21, 402)), bool(rng.integers(0, 2)),
            float(rng.uniform(-6.0, 12.0)), int(rng.integers(51, 2002)),
            float(10.0 ** rng.uniform(-4.0, -2.0)))


def test_clark_y():
    np.testing.assert_array_equal(clark_y(), ref_clark_y())
    assert clark_y().dtype == ref_clark_y().dtype == np.float64


def test_shapes_keys():
    assert list(SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("name", list(REF_SHAPES))
def test_shape(name):
    got, want = SHAPES[name](), REF_SHAPES[name]()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_joukowski_defaults():
    np.testing.assert_array_equal(joukowski(), ref_joukowski())


@pytest.mark.parametrize("seed", range(6))
def test_joukowski(seed):
    mx, my, n, cosine, _alpha, _n_exact, _margin = _draws(seed)
    got = joukowski(mx, my, n, cosine)
    want = ref_joukowski(mx, my, n, cosine)
    assert got.shape == want.shape == (n, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_joukowski_exact(seed):
    mx, my, _n, _cosine, alpha, n_exact, margin = _draws(seed)
    got = joukowski_exact(mx, my, alpha, n=n_exact, te_margin=margin)
    want = ref_joukowski_exact(mx, my, alpha, n=n_exact, te_margin=margin)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _port_solve(mx, my, alpha):
    coords = joukowski(mx, my, 401)
    op = build_operator(panel_geometry(*repanel(coords, 160, device="cpu")))
    return solve_inviscid(op, alpha), op


@pytest.mark.parametrize("case", EXACT_CASES)
def test_solve_inviscid_exact(case):
    mx, my, alpha = case
    sol, op = _port_solve(mx, my, alpha)
    ex = joukowski_exact(mx, my, alpha, n=2001)
    cl = float(sol.cl)
    if abs(ex["cl"]) < 1e-6:
        assert abs(cl) < 5e-3, cl
    else:
        assert abs(cl / ex["cl"] - 1.0) < 0.015, (cl, ex["cl"])
    xm, ym = op.pan.xm.numpy(), op.pan.ym.numpy()
    pts = np.stack([ex["x"], ex["y"]], 1)
    mids = np.stack([xm, ym], 1)
    d = np.linalg.norm(pts[None] - mids[:, None], axis=2)
    err = sol.cp.numpy() - ex["cp"][d.argmin(1)]
    keep = xm < 0.98                       # away from the cusp
    rms = float(np.sqrt(np.mean(err[keep] ** 2)))
    assert rms < 0.035, rms


@pytest.mark.parametrize("nodes", ["port", "jax"])
@pytest.mark.parametrize("case", EXACT_CASES)
def test_solve_inviscid_against_jax(case, nodes):
    mx, my, alpha = case
    if nodes == "port":
        xp, yp = (t.numpy() for t in repanel(joukowski(mx, my, 401), 160,
                                             device="cpu"))
    else:
        xp, yp = (np.asarray(a) for a in jrepanel(ref_joukowski(mx, my, 401),
                                                  160))
    sol = solve_inviscid(build_operator(panel_geometry(
        *(torch.tensor(a) for a in (xp, yp)))), alpha)
    ref = jsolve(jbuild(jgeom(xp, yp)), alpha)
    for name in ("cl", "cm"):
        got, want = float(getattr(sol, name)), float(getattr(ref, name))
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-5, (name, got, want)
