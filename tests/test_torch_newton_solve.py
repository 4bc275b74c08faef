"""The port's Newton solves on the CPU against the JAX package's goldens
(``tests/golden/torch_newton.json``, written by
``tests/make_torch_newton_goldens.py``) at the reduced shape (32 stations
a side, 8 in the wake, 2 warm passes): a solve at the reference's
defaults takes minutes on a CPU, almost all of it the plain march.

The port builds its own geometry (NACA 4-digit, 100 points a side, 160
panels) and solves end to end. The Newton solve lands in one of several
transition basins where a crossing sits between stations, and which one
turns on float32 rounding; so each answer is held to the reference's
rounding ensemble (Re (1 + k 2^-23) and alpha + k 1e-5 degrees, k =
-16..16): ``converged`` one of its values, and CL within 0.025, CD within
5 %, Cm within 0.01 and each x_transition within 0.05 c of the range over
the members with the same ``converged`` (``chip_smoke.held_to_members``).
The continuation solves start from the reference's donor state, carried
across by ``state_from_numpy``.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.paneling import panel_geometry, repanel
from airfoil_tpu_torch.viscous import newton
from chip_smoke import (NEWTON_GOLDENS, _viscous_record, held_to_members,
                        load_goldens, merged_record)

GOLDEN = load_goldens(NEWTON_GOLDENS)
SHAPE = GOLDEN["reduced_config"]
CONT_SHAPE = {k: v for k, v in SHAPE.items() if k != "warm_iters"}
_OPS = {}


def _op(code: str):
    if code not in _OPS:
        coords = naca4(int(code[0]), int(code[1]), int(code[2:]), 100)
        _OPS[code] = build_operator(panel_geometry(
            *repanel(coords, 160, device="cpu")))
    return _OPS[code]


@pytest.mark.parametrize("i", range(len(GOLDEN["newton_reduced"])))
def test_solve_viscous_newton(i):
    g = GOLDEN["newton_reduced"][i]
    res = newton.solve_viscous_newton(_op(g["naca"]), g["alpha"], g["re"],
                                      **SHAPE)
    rec = _viscous_record(res)
    assert not held_to_members(rec, g), (g["naca"], g["alpha"], rec)
    assert res.converged.dtype == torch.bool
    assert res.cp.shape == (160,) and res.upper.theta.shape == (32,)
    assert bool(torch.isfinite(res.sigma).all())


@pytest.fixture(scope="module")
def cont():
    c = GOLDEN["continuation"]["reduced"]
    st = c["donor"]["state"]
    return c, newton.state_from_numpy(st["zz"], st["xtr_u"], st["xtr_l"],
                                      device="cpu")


def test_solve_polar_point(cont):
    c, donor = cont
    out = newton.solve_polar_point(_op(c["naca"]), c["donor_alpha"], c["re"],
                                   **SHAPE)
    rec = merged_record(out)
    assert not held_to_members(rec, c["donor"]), rec
    zz, xtr_u, xtr_l = out[1][1]
    assert zz.shape == donor[0].shape == (4 * (2 * 32 + 8),)
    assert xtr_u.shape == xtr_l.shape == ()


def test_solve_viscous_newton_cont(cont):
    c, donor = cont
    res = newton.solve_viscous_newton_cont(_op(c["naca"]), c["cont_alpha"],
                                           c["re"], *donor, **CONT_SHAPE)
    rec = _viscous_record(res)
    assert not held_to_members(rec, c["solve_viscous_newton_cont"]), rec


def test_solve_polar_point_cont(cont):
    c, donor = cont
    out = newton.solve_polar_point_cont(_op(c["naca"]), c["cont_alpha"],
                                        c["re"], *donor, **CONT_SHAPE)
    rec = merged_record(out)
    assert not held_to_members(rec, c["solve_polar_point_cont"]), rec
    assert rec["newton_converged"] in \
        c["solve_polar_point_cont"]["ensemble"]["newton_converged"]


def test_state_from_numpy():
    zz = np.linspace(-9.0, 2.0, 12, dtype=np.float32)
    st = newton.state_from_numpy(zz, 0.3, np.float32(2.0), device="cpu")
    assert [t.dtype for t in st] == [torch.float32] * 3
    assert torch.equal(st[0], torch.tensor(zz))
    assert (float(st[1]), float(st[2])) == (pytest.approx(0.3), 2.0)
