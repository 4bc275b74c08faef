"""The port's wake operator and coupled solve
(``airfoil_tpu_torch.viscous.wake``, ``.coupled``) and its marches on
airfoil sides, against the JAX reference on the CPU.

Both packages get the same operator: the reference's ``InviscidOperator``
fields go to the port through ``operator_from_numpy``, so the coupling is
compared apart from the panel solver (only the LU is factored again).

The direct coupling iteration, and the march on an airfoil side, can turn
on float32 rounding: where a laminar layer nears separation the 8-step
Newton of a station has two roots in reach and no convergence, and which
one it ends on decides a transition station. The reference itself shows
it: a one-ulp change of its input moves its own answer there. So where a
single reference run would be a knife edge, the tests hold the port to the
reference's rounding ensemble (the same run with an input scaled by
1 + k 2^-23), with the stated bars around the ensemble's range.

Tolerances:
- wake operator and coupling helpers: rtol 1e-5 with atol 1e-5 of each
  field's largest magnitude;
- side marches: theta, dstar, hk, cf rtol 1e-4 and identical flags on
  every station before the first one where the reference's own ensemble
  (k = -16..16 on ue) spreads beyond that bar; x_transition one of the
  ensemble's values (exactly). Where both sides are tripped near the
  leading edge the knife edge cannot arise, and ``test_torch_tripped.py``
  holds the port to one reference run on every station;
- ``solve_viscous`` (64 panels, 24 stations, 8 wake stations, 6 passes):
  CL within 0.025 absolute, CD within 5 %, Cm within 0.01 and x_transition
  within 0.05 c of the reference ensemble's range (Re scaled by
  1 + k 2^-23 and alpha offset by k 1e-5 degrees, k = -16..16), and
  ``converged`` one of the ensemble's values. At 2412 alpha 4 the port
  lands on the nominal reference run (CL within 6e-6, the same
  transitions); the ensemble spans CD 0.0061-0.0082 there, and at alpha 0
  CD 0.0043-0.0064 (2412) and 0.0034-0.0070 (0012).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.inviscid import build_operator as jbuild
from airfoil_tpu.inviscid import solve_inviscid as jsolve
from airfoil_tpu.models import naca4
from airfoil_tpu.paneling import panel_geometry as jgeom
from airfoil_tpu.paneling import repanel as jrepanel
from airfoil_tpu.viscous import coupled as jc
from airfoil_tpu.viscous import march as jmarch
from airfoil_tpu.viscous import wake as jw
from airfoil_tpu_torch.inviscid import operator_from_numpy
from airfoil_tpu_torch.viscous import coupled as tc
from airfoil_tpu_torch.viscous import kernel
from airfoil_tpu_torch.viscous import wake as tw
from chip_smoke import ENSEMBLE_K, MARCH_RTOL, ensemble_stop
from make_torch_goldens import ensemble_inputs
from torch_parity import as_numpy, compare, to_torch

CPU = "cpu"
SMALL = dict(n_stations=24, n_wake=8, coupling_iters=6)
_OPS = {}


def _fields(op):
    f = {k: np.asarray(v) for k, v in op._asdict().items() if k != "pan"}
    f["pan"] = {k: np.asarray(v) for k, v in op.pan._asdict().items()}
    return f


def _ops(code: str, n: int):
    """(port operator from the reference's fields, reference operator)."""
    if (code, n) not in _OPS:
        coords = naca4(int(code[0]), int(code[1]), int(code[2:]), 100)
        ref = jbuild(jgeom(*jrepanel(coords, n)))
        _OPS[code, n] = (operator_from_numpy(_fields(ref), CPU), ref)
    return _OPS[code, n]


# ── wake operator and coupling helpers ──────────────────────────────────────
@pytest.mark.parametrize("alpha", [0.0, 5.0])
def test_build_wake_operator(alpha):
    port_op, ref_op = _ops("2412", 64)
    port = tw.build_wake_operator(port_op, alpha, n_wake=24)
    ref = jw.build_wake_operator(ref_op, alpha, n_wake=24)
    compare(port, ref, rtol=1e-5, atol_scale=1e-5)


def test_blend_te_continuity():
    xi = np.linspace(0.0, 0.4, 17, dtype=np.float32)
    ue = np.linspace(0.8, 1.0, 17, dtype=np.float32)
    compare(tw.blend_te_continuity(*to_torch([xi, ue, np.float32(0.93)])),
            jw.blend_te_continuity(xi, ue, np.float32(0.93)), rtol=1e-6)


@pytest.fixture(scope="module")
def surface():
    """The reference's surface state at alpha 4 with a seeded mass
    defect, as numpy: the inputs of the coupling helpers."""
    port_op, ref_op = _ops("2412", 64)
    pan = ref_op.pan
    vt = jsolve(ref_op, 4.0).vt
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s_le = pan.s[jnp.argmin(pan.xp)]
    s0 = jc._find_stagnation(s_mid, vt, s_le)
    rng = np.random.default_rng(5)
    m = {side: np.cumsum(rng.uniform(0, 2e-4, 24)).astype(np.float32)
         for side in ("u", "l")}
    xi = {side: np.asarray(jc._side_stations(pan, vt, s0, side == "u", 24)[0])
          for side in ("u", "l")}
    return dict(port_pan=port_op.pan, ref_pan=pan, vt=np.asarray(vt),
                s_mid=np.asarray(s_mid), s_le=np.asarray(s_le),
                s0=np.asarray(s0), m=m, xi=xi)


def test_find_stagnation(surface):
    got = tc._find_stagnation(*to_torch([surface["s_mid"], surface["vt"],
                                         surface["s_le"]]))
    assert float(got) == pytest.approx(float(surface["s0"]), rel=1e-6)


@pytest.mark.parametrize("upper", [True, False])
def test_side_stations(surface, upper):
    ref = jc._side_stations(surface["ref_pan"], surface["vt"], surface["s0"],
                            upper, 24)
    port = tc._side_stations(surface["port_pan"],
                             *to_torch([surface["vt"], surface["s0"]]),
                             upper, 24)
    compare(port, ref, rtol=1e-5, atol_scale=1e-5)


def test_station_fractions():
    compare(tc._station_fractions(80), jc._station_fractions(80, jnp.float32),
            rtol=1e-6)


def test_smooth_clip_derivative(surface):
    xi, m = surface["xi"]["u"], surface["m"]["u"] * 300.0   # reaches the clip
    compare(tc._smooth_clip_derivative(*to_torch([xi, m])),
            jc._smooth_clip_derivative(xi, m), rtol=1e-5, atol_scale=1e-5)


@pytest.mark.parametrize("name", ["_sigma_from_sides",
                                  "_sigma_nodal_from_sides"])
def test_sigma_from_sides(surface, name):
    args = [surface["s0"], surface["xi"]["u"], surface["m"]["u"],
            surface["xi"]["l"], surface["m"]["l"]]
    ref = getattr(jc, name)(surface["ref_pan"], *args)
    port = getattr(tc, name)(surface["port_pan"], *to_torch(args))
    compare(port, ref, rtol=1e-5, atol_scale=1e-5)


def test_sigma_wake_nodal():
    port_op, ref_op = _ops("2412", 64)
    ref_w = jw.build_wake_operator(ref_op, 4.0, n_wake=8)
    port_w = tw.build_wake_operator(port_op, 4.0, n_wake=8)
    m_w = np.linspace(2e-3, 3e-3, 8, dtype=np.float32)
    args = [np.asarray(ref_w.xi), m_w, np.float32(1.9e-3)]
    compare(tc._sigma_wake_nodal(port_w.wpan, *to_torch(args)),
            jc._sigma_wake_nodal(ref_w.wpan, *args), rtol=1e-5,
            atol_scale=1e-5)


def test_forces_from_cp(surface):
    cp = (1.0 - surface["vt"] ** 2).astype(np.float32)
    compare(tc._forces_from_cp(surface["port_pan"], torch.tensor(cp), 4.0),
            jc._forces_from_cp(surface["ref_pan"], cp, 4.0), rtol=1e-5,
            atol=1e-6)


# ── side marches against the reference's rounding ensemble ──────────────────
def naca2412_sides():
    """The two sides of NACA 2412 at alpha 0 and 5 (160 panels, 80
    stations, ue from the reference's inviscid solve) as four lanes of
    numpy (s, ue, x)."""
    _, ref_op = _ops("2412", 160)
    pan = ref_op.pan
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s_le = pan.s[jnp.argmin(pan.xp)]
    rows = []
    for alpha in (0.0, 5.0):
        vt = jsolve(ref_op, alpha).vt
        s0 = jc._find_stagnation(s_mid, vt, s_le)
        for upper in (True, False):
            xi, _, ue, x, _ = jc._side_stations(pan, vt, s0, upper, 80)
            rows.append([np.asarray(a) for a in (xi, ue, x)])
    return [np.stack(c) for c in zip(*rows)]


def test_naca2412_sides_against_reference_ensemble():
    """The free sides, held up to the first station where the reference's
    own ensemble spreads."""
    s, ue, x = naca2412_sides()
    lanes, m = s.shape
    par = [np.full(lanes, v, np.float32) for v in (1e-6, 9.0, 1.0)]

    port = as_numpy(kernel.march_side(*to_torch([s, ue, x, *par])))
    k = len(ENSEMBLE_K)
    rep = lambda a: np.repeat(a, k, axis=0)
    scale = np.tile((1.0 + ENSEMBLE_K * 2.0 ** -23).astype(np.float32),
                    lanes)
    ens = as_numpy(jax.vmap(jmarch.march_side)(*(jnp.asarray(a) for a in (
        rep(s), (rep(ue) * scale[:, None]).astype(np.float32), rep(x),
        *(rep(p) for p in par)))))
    for lane in range(lanes):
        rows_l = slice(lane * k, (lane + 1) * k)
        nominal = {f: v[rows_l][k // 2] for f, v in ens.items()}
        stop = ensemble_stop({f: v[rows_l] for f, v in ens.items()})
        for f in ("theta", "dstar", "hk", "cf"):
            np.testing.assert_allclose(port[f][lane][:stop],
                                       nominal[f][:stop], rtol=MARCH_RTOL,
                                       err_msg=f"lane {lane} {f}")
        for f in ("turb", "separated"):
            np.testing.assert_array_equal(port[f][lane][:stop],
                                          nominal[f][:stop],
                                          err_msg=f"lane {lane} {f}")
        assert port["x_transition"][lane] in set(
            ens["x_transition"][rows_l].tolist()), lane


# ── the coupled solve ───────────────────────────────────────────────────────
BARS = {"cl": (0.025, 0.0), "cd": (0.0, 0.05), "cm": (0.01, 0.0),
        "xtr_upper": (0.05, 0.0), "xtr_lower": (0.05, 0.0)}


def _record(r):
    return {"cl": float(r.cl), "cd": float(r.cd), "cm": float(r.cm),
            "converged": bool(r.converged),
            "xtr_upper": float(r.upper.x_transition),
            "xtr_lower": float(r.lower.x_transition)}


@pytest.mark.parametrize("code,alpha", [("2412", 0.0), ("2412", 4.0),
                                        ("0012", 0.0)])
def test_solve_viscous_against_reference_ensemble(code, alpha):
    port_op, ref_op = _ops(code, 64)
    port = tc.solve_viscous(port_op, alpha, 1e6, **SMALL)
    got = _record(port)
    ens = [_record(jc.solve_viscous(ref_op, a, re, **SMALL))
           for a, re in ensemble_inputs(alpha, 1e6)]
    for f, (abs_bar, rel_bar) in BARS.items():
        lo = min(e[f] for e in ens)
        hi = max(e[f] for e in ens)
        assert (lo - abs_bar - rel_bar * abs(lo) <= got[f]
                <= hi + abs_bar + rel_bar * abs(hi)), (f, got[f], lo, hi)
    assert got["converged"] in {e["converged"] for e in ens}
    assert port.cp.shape == (64,) and port.upper.theta.shape == (24,)
    assert port.converged.dtype == torch.bool
    assert bool(torch.isfinite(port.sigma).all())
