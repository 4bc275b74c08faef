"""The port's coupled solve and its marches where the reference is no
knife edge, against one JAX reference run on the CPU.

Tripped near the leading edge (``x_forced_transition`` 0.05), neither side
has a laminar run that can separate, so the transition station is fixed
and the reference's rounding ensemble is tight (over k = -16..16 it spans
~4e-5 in CL and ~1e-7 in CD; see ``tests/make_torch_goldens.py``). So here
the port is held to the nominal reference run itself, at these bars:

- side marches, NACA 2412 at alpha 0 and 5 (160 panels, 80 stations):
  theta, dstar, hk, cf within rtol 1e-4, identical flags and x_transition,
  on every station;
- the marches the coupled solves below make, on the inputs they gave them
  (every side-pair and wake march, recorded as it reached
  ``viscous.kernel``): the same bars (rtol 1e-4 for the wake's theta,
  dstar, hk), on every station but one: the last station of a side can
  leave its 8-step Newton unconverged where ue falls steeply into the
  trailing edge on this coarse grid, and there the reference's own
  ensemble spreads (by 7e-4 in dstar on one of the 28 side lanes), so a
  side is held up to the first station where that ensemble spreads,
  which must be the last one or none;
- ``solve_viscous`` (64 panels, 24 stations, 8 wake stations, 6 passes) at
  NACA 2412 alpha 4 and NACA 0012 alpha 0, Re 1e6: CL within 0.025, CD
  within 5 %, Cm within 0.01, x_transition within 0.05 c, ``converged``
  equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from airfoil_tpu.viscous import coupled as jc
from airfoil_tpu.viscous import march as jmarch
from airfoil_tpu_torch.viscous import coupled as tc
from airfoil_tpu_torch.viscous import kernel
from chip_smoke import (ENSEMBLE_K, MARCH_RTOL, _stack_calls,
                        ensemble_stop, recording)
from make_torch_goldens import TRIP_X
from test_torch_coupled import BARS, SMALL, _ops, _record, naca2412_sides
from torch_parity import as_numpy, to_torch

POINTS = [("2412", 4.0), ("0012", 0.0)]
_SOLVES = {}


def _tripped_solve(code: str, alpha: float):
    """The port's tripped solve at the small configuration and the march
    calls it made."""
    if (code, alpha) not in _SOLVES:
        port_op, _ = _ops(code, 64)
        with recording(kernel) as calls:
            res = tc.solve_viscous(port_op, alpha, 1e6,
                                   x_forced_transition=TRIP_X, **SMALL)
        _SOLVES[code, alpha] = res, calls
    return _SOLVES[code, alpha]


def _hold_sides(port: dict, ref: dict, label: str, stop=None) -> None:
    """Station fields on stations [0, stop), x_transition exactly."""
    for f in ("theta", "dstar", "hk", "cf"):
        np.testing.assert_allclose(port[f][..., :stop], ref[f][..., :stop],
                                   rtol=MARCH_RTOL, err_msg=f"{label} {f}")
    for f in ("turb", "separated"):
        np.testing.assert_array_equal(port[f][..., :stop],
                                      ref[f][..., :stop],
                                      err_msg=f"{label} {f}")
    np.testing.assert_array_equal(port["x_transition"], ref["x_transition"],
                                  err_msg=f"{label} x_transition")


def test_naca2412_sides_tripped_against_reference():
    s, ue, x = naca2412_sides()
    par = [np.full(s.shape[0], v, np.float32) for v in (1e-6, 9.0, TRIP_X)]
    port = as_numpy(kernel.march_side(*to_torch([s, ue, x, *par])))
    ref = as_numpy(jax.vmap(jmarch.march_side)(
        *(jnp.asarray(a) for a in (s, ue, x, *par))))
    _hold_sides(port, ref, "NACA 2412 sides")
    assert (port["x_transition"] < 0.1).all()     # the trip, not free


@pytest.mark.parametrize("code,alpha", POINTS)
def test_solve_viscous_tripped_against_reference(code, alpha):
    _, ref_op = _ops(code, 64)
    port, _ = _tripped_solve(code, alpha)
    got = _record(port)
    ref = _record(jc.solve_viscous(ref_op, alpha, 1e6,
                                   x_forced_transition=TRIP_X, **SMALL))
    for f, (abs_bar, rel_bar) in BARS.items():
        assert abs(got[f] - ref[f]) <= abs_bar + rel_bar * abs(ref[f]), \
            (f, got[f], ref[f])
    assert got["converged"] == ref["converged"]
    assert got["xtr_upper"] < 0.1 and got["xtr_lower"] < 0.1


def test_main_path_marches_against_reference():
    """Every side-pair and wake march of the tripped solves, as lanes of
    one march each."""
    sides, wakes = [], []
    for point in POINTS:
        _, calls = _tripped_solve(*point)
        sides += calls["march_side"]
        wakes += calls["march_wake"]
    passes = SMALL["coupling_iters"] + 1
    assert len(sides) == len(wakes) == len(POINTS) * passes

    side_args = [a.numpy() for a in _stack_calls(sides, 3)]
    lanes, m = side_args[0].shape
    assert (lanes, m) == (2 * len(sides), SMALL["n_stations"])
    port = as_numpy(kernel.march_side(*to_torch(side_args)))
    # The reference's rounding ensemble of every lane (ue scaled by
    # 1 + k 2^-23), the nominal member in the middle.
    k = len(ENSEMBLE_K)
    rep = lambda a: np.repeat(a, k, axis=0)
    scale = np.tile((1.0 + ENSEMBLE_K * 2.0 ** -23).astype(np.float32),
                    lanes)
    ens = as_numpy(jax.vmap(jmarch.march_side)(*map(jnp.asarray, (
        rep(side_args[0]), (rep(side_args[1]) * scale[:, None]
                            ).astype(np.float32),
        *(rep(a) for a in side_args[2:])))))
    for lane in range(lanes):
        member = {f: v[lane * k:(lane + 1) * k] for f, v in ens.items()}
        stop = ensemble_stop(member)
        assert stop >= m - 1, (lane, stop)
        _hold_sides({f: v[lane] for f, v in port.items()},
                    {f: v[k // 2] for f, v in member.items()},
                    f"side-pair lane {lane}", stop)

    wake_args = [a.numpy() for a in _stack_calls(wakes, 2)]
    assert wake_args[0].shape == (len(wakes), SMALL["n_wake"])
    port_w = as_numpy(kernel.march_wake(*to_torch(wake_args)))
    ref_w = as_numpy(jax.vmap(jmarch.march_wake)(*map(jnp.asarray,
                                                      wake_args)))
    for p, r, f in zip(port_w, ref_w, ("theta", "dstar", "hk")):
        np.testing.assert_allclose(p, r, rtol=MARCH_RTOL,
                                   err_msg=f"wake {f}")
