"""The lane-batched Newton solve (``newton.solve_polar_points``) against
one-lane solves of the same points, on the CPU, at the reduced shape of
the port's Newton tests (32 stations a side, 8 wake stations, 2 warm
passes), with 3 LM iterations a round so that the lanes need different
numbers of rounds.

- A polar's lanes (one operator, three alphas): each lane's answer equals
  the one-lane ``solve_polar_point`` of its point, outputs to rtol 1e-5
  (atol 1e-6, for values near zero such as the symmetric section's Cm)
  and the same ``converged``; the lanes settle after different numbers of
  rounds, so the settled lanes' frozen carry is exercised.
- A batch's lanes (one operator a lane, NACA 2412 and 0012): the same.

The one-lane solve is the one-lane case of the same code; what differs is
the batching of the marches and of the linear algebra, whose rounding
moves a converged answer by ~1e-6.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.paneling import panel_geometry, repanel
from airfoil_tpu_torch.viscous import newton

SHAPE = {"n_stations": 32, "n_wake": 8, "warm_iters": 2, "newton_iters": 3}
RE = 1e6
ALPHAS = [-4.0, 0.0, 2.0]
_OPS, _ONE = {}, {}


def _op(code: str):
    if code not in _OPS:
        coords = naca4(int(code[0]), int(code[1]), int(code[2:]), 100)
        _OPS[code] = build_operator(panel_geometry(
            *repanel(coords, 160, device="cpu")))
    return _OPS[code]


def _one_lane(code: str, alpha: float):
    """The one-lane solve of a point (cached: the tests share points)."""
    if (code, alpha) not in _ONE:
        _ONE[code, alpha] = newton.solve_polar_point(_op(code), alpha, RE,
                                                     **SHAPE)
    return _ONE[code, alpha]


def _lanes(op, alphas):
    """``solve_polar_points`` and the rounds each lane ran."""
    rounds = []
    orig = newton._lm_rounds

    def counted(*args):
        out = orig(*args)
        rounds.append(out[2].tolist())
        return out

    newton._lm_rounds = counted
    try:
        out = newton.solve_polar_points(op, alphas, RE, **SHAPE)
    finally:
        newton._lm_rounds = orig
    return out, rounds[0]


def _hold_lane(out, i, want):
    merged, (nok, (zz, xu, xl)) = out
    w_merged, (w_nok, (w_zz, w_xu, w_xl)) = want
    assert bool(nok[i]) == bool(w_nok)
    assert bool(merged[4][i]) == bool(w_merged[4])
    got = np.array([float(m[i]) for k, m in enumerate(merged) if k != 4])
    exp = np.array([float(m) for k, m in enumerate(w_merged) if k != 4])
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([float(xu[i]), float(xl[i])],
                               [float(w_xu), float(w_xl)], rtol=1e-5)
    assert zz.shape[-1] == w_zz.shape[0] == 4 * (2 * 32 + 8)


@pytest.fixture(scope="module")
def polar_lanes():
    return _lanes(_op("2412"), torch.tensor(ALPHAS))


@pytest.mark.parametrize("i", range(len(ALPHAS)))
def test_polar_lane_equals_one_lane_solve(polar_lanes, i):
    out, _rounds = polar_lanes
    _hold_lane(out, i, _one_lane("2412", ALPHAS[i]))
    assert bool(out[1][0][i])          # every lane of this polar converges


def test_lanes_settle_in_different_rounds(polar_lanes):
    out, rounds = polar_lanes
    assert len(set(rounds)) > 1, rounds
    assert out[0][0].shape == (len(ALPHAS),)
    assert out[1][1][0].shape == (len(ALPHAS), 4 * (2 * 32 + 8))


def test_batch_lanes_equal_one_lane_solves():
    codes = ("2412", "0012")
    out, _rounds = _lanes([_op(c) for c in codes], 2.0)
    for i, code in enumerate(codes):
        _hold_lane(out, i, _one_lane(code, 2.0))
    # Different geometries, different answers.
    assert abs(float(out[0][0][0]) - float(out[0][0][1])) > 0.1
