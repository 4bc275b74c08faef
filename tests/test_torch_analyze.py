"""The port's ``analyze_airfoil`` (``airfoil_tpu_torch.polar``) against the
JAX package's, on the CPU.

- Control flow: both packages' solvers are replaced by recorders that
  answer with scripted ``converged`` flags (one flag a call, in order;
  False once the script is spent). For every pattern and alpha the port
  must make the same calls, at the same alphas, with the same donor states
  and options, as the JAX function, and give the same strategy, mode and
  answer. The geometry, the smoothing and the inviscid fallback are real
  (Cp positions to 1e-6 relative, the inviscid CL and Cm to 2e-4 after the
  reference's rounding to 4 places).
- ``_bl_payload`` equals JAX's on the same arrays.
- The recorded run of the reference at NACA 2412 alpha 19 (golden (d),
  ``tests/golden/torch_newton.json``): scripted with the flags the
  reference's solvers returned there, the port makes the same calls and
  answers inviscid with the warning, CD 0, and the golden's CL, Cm and Cp
  to 1e-4.
- The slow tier runs the real default analysis at alpha 4 and 19 and holds
  it to golden (d): alpha 4 viscous within CL 0.025, CD 5 % and Cm 0.01 of
  the reference ensemble's range, with the full boundary-layer schema.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu.models import naca4
from airfoil_tpu.polar import analyze as jax_analyze
from airfoil_tpu.viscous import coupled as jc
from airfoil_tpu.viscous import newton as jax_newton
from airfoil_tpu_torch.polar import INVISCID_WARNING, analyze_airfoil
from airfoil_tpu_torch.polar import analyze as port_analyze
from airfoil_tpu_torch.viscous import coupled as tc
from chip_smoke import NEWTON_GOLDENS, load_goldens

GOLDEN = load_goldens(NEWTON_GOLDENS)
COORDS = naca4(2, 4, 12, 80)
SOLVERS = ("solve_viscous_newton", "solve_polar_point",
           "solve_polar_point_cont", "solve_viscous_newton_cont",
           "solve_viscous")


def _arrays(seed: int = 0, n: int = 6) -> dict:
    """Numpy arrays of a made-up ViscousResult (two 6-station sides)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)

    def side(xtr):
        return dict(x=f32(np.linspace(0.0, 1.0, n)), y=f32(rng.random(n)),
                    s=f32(np.linspace(0.01, 1.0, n)), ue=f32(rng.random(n)),
                    theta=f32(1e-3 * rng.random(n)),
                    dstar=f32(2e-3 * rng.random(n)),
                    hk=f32(1.5 + rng.random(n)), cf=f32(1e-3 * rng.random(n)),
                    turb=rng.random(n) > 0.5, x_transition=f32(xtr))

    return dict(cl=f32(0.61234567), cd=f32(0.00712345), cdp=f32(0.0021234),
                cm=f32(-0.0512345), cp=f32(rng.standard_normal(160)),
                upper=side(0.4123), lower=side(0.995),
                sep_fraction=f32(0.0123), sigma=f32(np.zeros(160)),
                sigma_wake=f32(np.zeros(20)))


def _result(pkg, arrays: dict, converged: bool):
    """``arrays`` as the package's ViscousResult (numpy for JAX's
    functions, tensors for the port's)."""
    conv = lambda a: torch.tensor(a) if pkg is tc else a
    sides = {k: pkg.SideBL(**{f: conv(v) for f, v in arrays[k].items()})
             for k in ("upper", "lower")}
    rest = {k: conv(v) for k, v in arrays.items()
            if k not in ("upper", "lower")}
    return pkg.ViscousResult(**rest, **sides,
                             converged=conv(np.bool_(converged)))


class Script:
    """Recorders for the five solvers: each call takes the next flag and
    logs (solver, alpha, donor state's origin, options)."""

    def __init__(self, pkg, flags):
        self.pkg, self.flags, self.calls = pkg, list(flags), []
        self.arrays = _arrays()

    def _log(self, name, alpha, state, kw) -> bool:
        self.calls.append((name, alpha, state, tuple(sorted(kw.items()))))
        return self.flags.pop(0) if self.flags else False

    def _point(self, flag):
        state = (f"state of call {len(self.calls) - 1}", 0.1, 0.2)
        merged = (0.5, 0.01, 0.005, -0.05, flag, 0.3, 0.9, 0.0)
        return merged, (flag, state)

    def solver(self, name):
        def run(op, alpha, reynolds, *state, **kw):
            assert reynolds == 1e6
            flag = self._log(name, alpha, state[0] if state else None, kw)
            if name in ("solve_polar_point", "solve_polar_point_cont"):
                return self._point(flag)
            return _result(self.pkg, self.arrays, flag)
        return run


def _run_both(monkeypatch, flags, alpha):
    """Both analyses under the same script: ((port result, calls), (JAX
    result, calls))."""
    out = []
    for pkg, an, newton_mod, kw in (
            (tc, port_analyze, port_analyze, {"device": "cpu"}),
            (jc, jax_analyze, jax_newton, {})):
        script = Script(pkg, flags)
        for name in SOLVERS:
            mod = an if name in ("solve_viscous_newton",
                                 "solve_viscous") else newton_mod
            monkeypatch.setattr(mod, name, script.solver(name))
        out.append((analyze_airfoil(COORDS, 1e6, alpha, **kw)
                    if pkg is tc else
                    jax_analyze.analyze_airfoil(COORDS, 1e6, alpha),
                    script.calls))
    return out


# Flags in call order (N = Newton, S = seed point, H = hop, C = continuation
# to the target, D = direct solve; a hop only where the gap is wide).
PATTERNS = ["T", "FFT", "FTT", "FTFT", "FTTFT", "FTTT", "FFFT", "FFFFFT",
            "FTTFFFTTT", "", "FTFFFFT", "FTTFFFTFFT"]
ALPHAS = [2.0, 10.0, -8.0, 19.0]


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_control_flow(monkeypatch, pattern, alpha):
    flags = [c == "T" for c in pattern]
    (port, port_calls), (ref, ref_calls) = _run_both(monkeypatch, flags,
                                                     alpha)
    assert port_calls == ref_calls
    assert (port.mode, port.strategy, port.converged) == \
        (ref.mode, ref.strategy, ref.converged)
    assert port.bl_data == ref.bl_data
    np.testing.assert_allclose(port.cp_x, ref.cp_x, rtol=1e-6, atol=1e-7)
    if port.mode == "viscous":
        assert port.coefficients == ref.coefficients
        assert port.cp_values == ref.cp_values
        assert port.sep_fraction == ref.sep_fraction
    else:
        assert port.coefficients.keys() == ref.coefficients.keys()
        for k in ("CL", "Cm"):
            assert port.coefficients[k] == pytest.approx(
                ref.coefficients[k], abs=2e-4)
        assert port.coefficients["warning"] == INVISCID_WARNING
        np.testing.assert_allclose(port.cp_values, ref.cp_values, rtol=1e-4,
                                   atol=1e-4)


def test_bl_payload():
    arrays = _arrays(3)
    port = port_analyze._bl_payload(_result(tc, arrays, True))
    ref = jax_analyze._bl_payload(_result(jc, arrays, True))
    assert port == ref
    assert port["transition_upper_x"] is not None
    assert port["transition_lower_x"] is None          # x_tr >= 0.99


def test_alpha19_calls_and_answer_of_the_reference_run(monkeypatch):
    g = next(a for a in GOLDEN["analyze"] if a["alpha"] == 19.0)
    script = Script(tc, [conv for _name, _alpha, conv in g["calls"]])
    for name in SOLVERS:
        monkeypatch.setattr(port_analyze, name, script.solver(name))
    res = analyze_airfoil(naca4(2, 4, 12, g["coords"]), g["re"], g["alpha"],
                          device="cpu")
    assert [[c[0], c[1]] for c in script.calls] == \
        [[name, alpha] for name, alpha, _conv in g["calls"]]
    assert (res.mode, res.strategy, res.bl_data) == ("inviscid", 3, None)
    assert res.coefficients["CD"] == res.coefficients["CDp"] == 0.0
    assert res.coefficients["warning"] == INVISCID_WARNING == \
        g["coefficients"]["warning"]
    for k in ("CL", "Cm"):
        assert res.coefficients[k] == pytest.approx(g["coefficients"][k],
                                                    abs=1e-4)
    np.testing.assert_allclose(res.cp_values, g["cp_values"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res.cp_x, g["cp_x"], rtol=1e-6, atol=1e-7)


@pytest.mark.slow
@pytest.mark.parametrize("alpha", [4.0, 19.0])
def test_default_analysis_against_golden(alpha):
    """The real default analysis (minutes on a CPU)."""
    g = next(a for a in GOLDEN["analyze"] if a["alpha"] == alpha)
    res = analyze_airfoil(naca4(2, 4, 12, g["coords"]), g["re"], alpha,
                          device="cpu")
    assert (res.mode, res.strategy) == (g["mode"], g["strategy"])
    if res.mode == "inviscid":
        assert res.coefficients["CD"] == 0.0
        assert res.coefficients["CL"] == pytest.approx(
            g["coefficients"]["CL"], abs=1e-4)
        return
    ens = g["ensemble"]
    c = res.coefficients
    for key, f, (abs_bar, rel_bar) in (("CL", "cl", (0.025, 0.0)),
                                       ("CD", "cd", (0.0, 0.05)),
                                       ("Cm", "cm", (0.01, 0.0))):
        lo, hi = ens[f]
        assert lo - abs_bar - rel_bar * lo <= c[key] \
            <= hi + abs_bar + rel_bar * hi, (key, c[key], lo, hi)
    assert set(res.bl_data) == set(g["bl_data"])
    assert len(res.bl_data["upper"]) == len(g["bl_data"]["upper"])
    assert set(res.bl_data["upper"][0]) == {"x", "y", "dstar", "theta",
                                            "cf", "H"}
