"""The port's panel solver (``airfoil_tpu_torch.inviscid``) against the
JAX reference on the CPU, on the same nodes (the reference's ``repanel``
output, as numpy, goes to both ``panel_geometry``s).

Tolerances: rtol 1e-5 with atol 1e-5 of each field's largest magnitude
(fields cross zero) for the assembled maps (``a_full``, ``bn``,
``at_full``, ``bt``, ``rhs_scale``) and, on the NACA sections, for the
solved ones (``due_dsigma``, ``dgamma_dsigma``) and the solution (gamma,
vt, cp); CL and Cm within 1e-5 absolute. On the cusped Joukowski section
the system is nearly singular at the trailing edge by design (the
sharp-TE row blend), so the two float32 LU factorisations give nodal
gammas that differ by ~1e-2 near the cusp; there the solved fields are
held by backward error (the residual of the reference's own system, 1e-5
of the right-hand side) and CL/Cm by 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu.inviscid import build_operator as jbuild
from airfoil_tpu.inviscid import solve_inviscid as jsolve
from airfoil_tpu.inviscid import velocity_at_points as jvel
from airfoil_tpu.models import joukowski as ref_joukowski
from airfoil_tpu.models import naca4 as ref_naca4
from airfoil_tpu.paneling import panel_geometry as jgeom
from airfoil_tpu.paneling import repanel as jrepanel
from airfoil_tpu_torch.inviscid import (build_operator, operator_from_numpy,
                                        solve_inviscid, velocity_at_points)
from airfoil_tpu_torch.models import joukowski, naca4
from airfoil_tpu_torch.paneling import panel_geometry, repanel
from torch_parity import as_numpy, compare, to_torch

CPU = "cpu"
# The reference's shapes (nodes from its repanel go to both solvers) and
# the port's own copies, for what the port computes alone.
SECTIONS = {"naca0012": lambda: ref_naca4(0, 0, 12, 100),
            "naca2412": lambda: ref_naca4(2, 4, 12, 100),
            "naca4412": lambda: ref_naca4(4, 4, 12, 100),
            "joukowski": lambda: ref_joukowski()}
PORT_SECTIONS = {"naca0012": lambda: naca4(0, 0, 12, 100),
                 "naca2412": lambda: naca4(2, 4, 12, 100),
                 "naca4412": lambda: naca4(4, 4, 12, 100),
                 "joukowski": lambda: joukowski()}
ASSEMBLED = ["a_full", "bn", "at_full", "bt", "at_a", "at_b", "rhs_scale"]
SOLVED = ["due_dsigma", "dgamma_dsigma"]

_CACHE = {}


def _ops(section, n=160):
    """(port operator, reference operator) from the same nodes."""
    key = (section, n)
    if key not in _CACHE:
        xp, yp = (np.asarray(a) for a in jrepanel(SECTIONS[section](), n))
        ref = jbuild(jgeom(xp, yp))
        port = build_operator(panel_geometry(*to_torch([xp, yp])))
        _CACHE[key] = (port, ref)
    return _CACHE[key]


def _fields(op):
    f = {k: np.asarray(v) for k, v in op._asdict().items() if k != "pan"}
    f["pan"] = {k: np.asarray(v) for k, v in op.pan._asdict().items()}
    return f


@pytest.mark.parametrize("section", list(SECTIONS))
def test_build_operator_assembled_fields(section):
    port, ref = _ops(section)
    compare(port, ref, rtol=1e-5, atol_scale=1e-5, fields=ASSEMBLED)
    assert port.a_full.dtype == torch.float32


@pytest.mark.parametrize("section", ["naca0012", "naca2412", "naca4412"])
def test_build_operator_solved_fields(section):
    port, ref = _ops(section)
    compare(port, ref, rtol=1e-5, atol_scale=1e-5, fields=SOLVED)


def test_build_operator_cusped_backward_error():
    """The Joukowski cusp: the port's solved maps satisfy the reference's
    system with a normwise backward error (per column, |A g - b| /
    (|A| |g| + |b|) in the max norm) below 1e-6, about 8 float32 ulps; the
    reference's own is ~4e-8 and the port's ~9e-8."""
    port, ref = _ops("joukowski")
    a = np.asarray(ref.a_full, np.float64)
    n = a.shape[0] - 1
    rhs = np.concatenate([-np.asarray(ref.bn), np.zeros((1, n))], 0)
    g = port.dgamma_dsigma.numpy().astype(np.float64)
    resid = np.abs(a @ g - rhs).max(axis=0)
    scale = (np.abs(a).sum(axis=1).max() * np.abs(g).max(axis=0)
             + np.abs(rhs).max(axis=0))
    assert (resid / scale).max() < 1e-6, (resid / scale).max()


@pytest.mark.parametrize("alpha", [-4.0, 0.0, 5.0])
@pytest.mark.parametrize("section", list(SECTIONS))
def test_solve_inviscid(section, alpha):
    port_op, ref_op = _ops(section)
    port = solve_inviscid(port_op, alpha)
    ref = jsolve(ref_op, alpha)
    assert abs(float(port.cl) - float(ref.cl)) < 1e-5
    assert abs(float(port.cm) - float(ref.cm)) < 1e-5
    if section != "joukowski":
        compare(port, ref, rtol=1e-5, atol_scale=1e-5,
                fields=["gamma", "vt", "cp"])
        compare(port, ref, rtol=1e-4, atol=1e-5,
                fields=["cd_pressure", "circulation"])


@pytest.mark.parametrize("section", ["naca2412", "joukowski"])
def test_solve_inviscid_with_sigma(section):
    port_op, ref_op = _ops(section)
    n = port_op.pan.xm.shape[0]
    rng = np.random.default_rng(7)
    sigma = (1e-3 * rng.standard_normal(n)).astype(np.float32)
    port = solve_inviscid(port_op, 3.0, torch.tensor(sigma))
    ref = jsolve(ref_op, 3.0, sigma)
    assert abs(float(port.cl) - float(ref.cl)) < 1e-5
    assert abs(float(port.cm) - float(ref.cm)) < 1e-5
    if section != "joukowski":
        compare(port, ref, rtol=1e-5, atol_scale=1e-5,
                fields=["gamma", "vt", "cp"])


@pytest.mark.parametrize("section,alpha,cl,cm", [
    ("naca2412", 5.0, 0.856, -0.063),
    ("naca0012", 5.0, 0.599, None),
    ("naca4412", 0.0, 0.515, -0.110),
])
def test_anchors(section, alpha, cl, cm):
    """The verify-skill anchors, on the port alone, from its own repanel."""
    op = build_operator(panel_geometry(*repanel(PORT_SECTIONS[section](), 160,
                                                device=CPU)))
    sol = solve_inviscid(op, alpha)
    assert abs(float(sol.cl) - cl) < 0.01
    if cm is not None:
        assert abs(float(sol.cm) - cm) < 0.01


@pytest.mark.parametrize("with_sigma", [False, True])
def test_velocity_at_points(with_sigma):
    port_op, ref_op = _ops("naca2412")
    rng = np.random.default_rng(11)
    px = rng.uniform(-1.0, 2.5, 300).astype(np.float32)
    py = rng.uniform(-1.0, 1.0, 300).astype(np.float32)
    n = port_op.pan.xm.shape[0]
    sigma = ((1e-3 * rng.standard_normal(n)).astype(np.float32)
             if with_sigma else None)
    ref_sol = jsolve(ref_op, 4.0, sigma)
    gamma = np.asarray(ref_sol.gamma)
    ref = jvel(px, py, ref_op, gamma, 4.0, sigma)
    port = velocity_at_points(
        torch.tensor(px), torch.tensor(py), port_op, torch.tensor(gamma),
        4.0, None if sigma is None else torch.tensor(sigma))
    compare(port, ref, rtol=1e-5, atol_scale=1e-5)


def test_operator_from_numpy_round_trip():
    """The reference's fields, carried over, give the reference's solution
    (the LU is factored again, hence the solve tolerance)."""
    _, ref_op = _ops("naca2412")
    op = operator_from_numpy(_fields(ref_op), CPU)
    got = as_numpy(op)
    want = as_numpy(ref_op)
    for key in want:
        if key in ("lu", "piv"):
            continue
        compare(got[key], want[key], rtol=0.0, atol=0.0, name=key)
    assert op.a_full.device.type == "cpu" and op.lu.shape == op.a_full.shape
    compare(solve_inviscid(op, 5.0), jsolve(ref_op, 5.0), rtol=1e-5,
            atol_scale=1e-5, fields=["gamma", "vt", "cp", "cl", "cm"])
