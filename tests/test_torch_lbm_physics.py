"""Physics of the port's LBM on the CPU: the checks of tests/test_lbm.py
(TestStep and the force tests of TestDiagnostics) run on
``airfoil_tpu_torch`` at the same 96x48 lattice, steps and bounds.

They hold the port to physical behaviour rather than to the JAX numbers:
a uniform stream is a fixed point, the flow round an airfoil stays stable
and leaves a wake, lift grows with incidence, and the flow separates at
high incidence. The plain torch step is what a CPU tensor runs through
either kernel wrapper.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu.config import LBMConfig
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.lbm import core, diagnostics, masks

SMALL = LBMConfig(nx=96, ny=48)


def _setup(alpha=6.0, u0=SMALL.u0):
    mask = torch.tensor(masks.rasterize_airfoil(naca4(2, 4, 12, 40), alpha,
                                                SMALL))
    return core.equilibrium_init(SMALL.ny, SMALL.nx, u0, "cpu"), mask


@pytest.fixture(scope="module")
def after_800():
    """NACA 2412 at alpha=6 after 800 steps, shared by two tests."""
    f, mask = _setup()
    return core.lbm_step(f, mask, SMALL.u0, SMALL.tau, steps=800), mask


def _forces(alpha, steps):
    f, mask = _setup(alpha)
    f = core.lbm_step(f, mask, SMALL.u0, SMALL.tau, steps=steps)
    return [float(v) for v in diagnostics.forces_and_separation(
        f, mask, SMALL.u0, SMALL.chord_cells)]


class TestStep:
    def test_uniform_flow_is_fixed_point(self):
        f0 = core.equilibrium_init(SMALL.ny, SMALL.nx, SMALL.u0, "cpu")
        solid = torch.zeros((SMALL.ny, SMALL.nx))
        f1 = core.lbm_step(f0, solid, SMALL.u0, SMALL.tau, steps=10)
        assert float((f1 - f0).abs().max()) < 1e-5

    def test_stability_with_airfoil(self, after_800):
        f, mask = after_800
        assert bool(torch.isfinite(f).all())
        rho, _ux, _uy = core.macro_fields(f)
        assert 0.9 < float(torch.where(mask < 0.5, rho, 1.0).min()) < 1.1

    def test_wake_deficit_forms(self, after_800):
        f, mask = after_800
        _rho, ux, _uy = core.macro_fields(f)
        m = mask.numpy()
        # Behind the airfoil (downstream of solid columns), streamwise
        # velocity dips below freestream.
        solid_cols = np.where(m.any(axis=0))[0]
        wake_col = min(solid_cols.max() + 5, SMALL.nx - 2)
        assert float(ux[SMALL.ny // 2, wake_col]) < SMALL.u0 * 0.98

    def test_high_alpha_stays_finite(self):
        # The stability clamps must hold a broadside-ish case.
        f, mask = _setup(25.0, u0=0.1)
        f = core.lbm_step(f, mask, 0.1, SMALL.tau, steps=600)
        assert bool(torch.isfinite(f).all())


class TestForces:
    def test_lift_sign_and_alpha_trend(self):
        cls = []
        for alpha in (0.0, 10.0):
            cl, cd, _sep = _forces(alpha, 1200)
            cls.append(cl)
            assert cd > 0.0
        assert cls[1] > cls[0], "CL must grow with alpha"

    def test_separation_at_high_alpha(self):
        _cl, _cd, sep = _forces(22.0, 1500)
        assert sep > 0.05, "high alpha should show reversed flow"
