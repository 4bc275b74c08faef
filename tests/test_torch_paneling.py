"""The port's paneling (``airfoil_tpu_torch.paneling``) and its jnp
primitives (``airfoil_tpu_torch.numerics``) against the JAX reference.

Everything runs on the CPU with an explicit ``device="cpu"``; inputs are
made with numpy and handed to both packages (``tests/torch_parity.py``).

Tolerances: ``repanel`` rtol 1e-5 with atol 1e-6 chord: its arc stations
are float32 values ~2 chords long, so one ulp of them (2.4e-7) already
moves a node by that much near the leading edge, where x ~ 0 leaves a bare
rtol meaningless. ``panel_geometry`` (given the same nodes) rtol 1e-5 with
atol 1e-5 of each field's largest magnitude; ``smooth_geometry`` rtol 1e-6
(additions and halvings only); the numerics helpers rtol 1e-6, or exact
where the operations are the same.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu import paneling as jpan
from airfoil_tpu.geometry import parse_dat_file
from airfoil_tpu.models import naca4
from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch import paneling as tpan
from torch_parity import compare, run_both

CPU = "cpu"
CORPUS = os.path.join(os.path.dirname(__file__), "..", "airfoil_tpu", "bench",
                      "results", "corpus")


def _lednicer():
    coords, _ = parse_dat_file(os.path.join(CORPUS,
                                            "af0005_naca4_lednicer.dat"))
    return np.asarray(coords, dtype=np.float64)


SECTIONS = {"naca0012": lambda: naca4(0, 0, 12, 60),
            "naca2412": lambda: naca4(2, 4, 12, 60),
            "lednicer": _lednicer}


# ── numerics ────────────────────────────────────────────────────────────────
class TestInterp:
    XP = np.array([0.0, 0.5, 0.5, 1.0, 2.0, 4.0], np.float32)  # a repeated knot
    FP = np.array([1.0, 2.0, 3.0, -1.0, 0.5, 0.25], np.float32)

    def test_values_on_edge_inputs(self):
        x = np.array([-1.0, 0.0, 1e-7, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.99,
                      4.0, 4.0001, 10.0], np.float32)
        ref = jnp.interp(x, self.XP, self.FP)
        port = nm.interp(torch.tensor(x), torch.tensor(self.XP),
                         torch.tensor(self.FP))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("x0", [0.25, 0.5, 1.0, 2.0, 4.0, -0.5, 5.0])
    def test_slope_matches_jax_jvp(self, x0):
        """At a knot the slope is the right-hand segment's, as in JAX;
        outside the table it is 0."""
        xp, fp = jnp.asarray(self.XP), jnp.asarray(self.FP)
        _, ref = jax.jvp(lambda x: jnp.interp(x, xp, fp),
                         (jnp.float32(x0),), (jnp.float32(1.0),))
        _, port = torch.func.jvp(
            lambda x: nm.interp(x, torch.tensor(self.XP),
                                torch.tensor(self.FP)),
            (torch.tensor([x0]),), (torch.ones(1),))
        dual = nm.interp(nm.Dual(torch.tensor([x0]), torch.ones(1, 1)),
                         torch.tensor(self.XP), torch.tensor(self.FP))
        assert float(port[0]) == pytest.approx(float(ref), rel=1e-6)
        assert float(dual.t[0, 0]) == pytest.approx(float(ref), rel=1e-6)

    def test_batched_queries(self):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 5, (7, 9)).astype(np.float32)
        ref = jnp.interp(x, self.XP, self.FP)
        port = nm.interp(torch.tensor(x), torch.tensor(self.XP),
                         torch.tensor(self.FP))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


class TestReductions:
    @pytest.mark.parametrize("n", [2, 3, 17])
    def test_gradient_is_jnp_gradient(self, n):
        f = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(nm.gradient(torch.tensor(f)).numpy(),
                                      np.asarray(jnp.gradient(f)))

    @pytest.mark.parametrize("case", ["plain", "some-nan", "all-nan", "inf"])
    def test_nanmax_nanmin(self, case):
        x = {"plain": [1.0, -2.0, 3.0],
             "some-nan": [np.nan, -2.0, 3.0, np.nan],
             "all-nan": [np.nan, np.nan],
             "inf": [np.inf, -np.inf, np.nan]}[case]
        x = np.array(x, np.float32)
        for port_fn, ref_fn in ((nm.nanmax, jnp.nanmax),
                                (nm.nanmin, jnp.nanmin)):
            np.testing.assert_array_equal(port_fn(torch.tensor(x)).numpy(),
                                          np.asarray(ref_fn(x)))


class TestClipAndDual:
    @pytest.mark.parametrize("x0", [-1.0, 0.0, 0.5, 1.0, 2.0])
    def test_clip_value_and_tie_derivative(self, x0):
        """jnp.clip's derivative is 0.5 at a bound (torch.clamp's is 1)."""
        val, ref = jax.jvp(lambda x: jnp.clip(x, 0.0, 1.0),
                           (jnp.float32(x0),), (jnp.float32(1.0),))
        d = nm.clip(nm.Dual(torch.tensor([x0]), torch.ones(1, 1)), 0.0, 1.0)
        _, port = torch.func.jvp(lambda x: nm.clip(x, 0.0, 1.0),
                                 (torch.tensor([x0]),), (torch.ones(1),))
        assert float(d.v[0]) == float(val)
        assert float(d.t[0, 0]) == float(ref)
        assert float(port[0]) == float(ref)

    def test_clip_propagates_nan(self):
        x = torch.tensor([np.nan, 0.5])
        out = nm.clip(x, 0.0, 1.0)
        assert np.isnan(out[0].item()) and out[1].item() == 0.5

    def test_dual_matches_jax_jvp_on_a_composite(self):
        """Every Dual rule at once: pow (integer, float, dual exponent),
        div, exp/log/sqrt/tanh, where, maximum."""
        def f(x, lib, where, mx):
            a = lib.exp(-1.3 * x) * (x + 2.0) ** (0.3 * x - 1.7)
            b = lib.sqrt(x * x + 0.25) / (1.0 + x ** 2) - lib.tanh(x) ** 3
            c = where(x < 0.7, (0.9 - x) ** 1.6, lib.log(x + 0.5))
            return mx(a + b, c) + 2.0 / (x + 3.0)

        nm_lib = type("L", (), {"exp": staticmethod(nm.exp),
                                "log": staticmethod(nm.log),
                                "sqrt": staticmethod(nm.sqrt),
                                "tanh": staticmethod(nm.tanh)})
        xs = np.array([0.1, 0.5, 0.7, 0.9, 1.7], np.float32)
        for x0 in xs:
            val, ref = jax.jvp(lambda x: f(x, jnp, jnp.where, jnp.maximum),
                               (jnp.float32(x0),), (jnp.float32(1.0),))
            d = f(nm.Dual(torch.tensor([x0]), torch.ones(1, 1)), nm_lib,
                  nm.where, nm.maximum)
            assert float(d.v[0]) == pytest.approx(float(val), rel=1e-6)
            assert float(d.t[0, 0]) == pytest.approx(float(ref), rel=1e-5)


# ── paneling ────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("spacing", ["airfoil", "cosine", "uniform"])
@pytest.mark.parametrize("section", list(SECTIONS))
def test_repanel(section, spacing):
    coords = SECTIONS[section]()
    ref = jpan.repanel(coords, 160, spacing)
    port = tpan.repanel(coords, 160, spacing, device=CPU)
    assert port[0].dtype == torch.float32 and port[0].device.type == "cpu"
    compare(port, ref, rtol=1e-5, atol=1e-6)


def test_repanel_rejects_odd_and_unknown():
    coords = naca4(0, 0, 12, 60)
    with pytest.raises(ValueError, match="even"):
        tpan.repanel(coords, 161, "airfoil", device=CPU)
    with pytest.raises(ValueError, match="unknown spacing"):
        tpan.repanel(coords, 160, "chebyshev", device=CPU)
    # cosine and uniform take odd counts, as in the reference
    assert tpan.repanel(coords, 161, "cosine", device=CPU)[0].shape == (162,)


def test_repanel_keeps_tensor_device():
    coords = torch.tensor(naca4(2, 4, 12, 60), dtype=torch.float32)
    xp, _ = tpan.repanel(coords, 64)
    assert xp.device == coords.device


@pytest.mark.parametrize("section", list(SECTIONS))
def test_panel_geometry(section):
    xp, yp = (np.asarray(a) for a in jpan.repanel(SECTIONS[section](), 160))
    port, ref = run_both(jpan.panel_geometry, tpan.panel_geometry, xp, yp)
    compare(port, ref, rtol=1e-5, atol_scale=1e-5)


@pytest.mark.parametrize("passes", [1, 10])
def test_smooth_geometry(passes):
    xp, yp = (np.asarray(a) for a in jpan.repanel(naca4(2, 4, 12, 60), 120))
    rng = np.random.default_rng(3)
    yp = (yp + 1e-3 * rng.standard_normal(yp.shape)).astype(np.float32)
    port, ref = run_both(jpan.smooth_geometry, tpan.smooth_geometry, xp, yp,
                         passes=passes)
    compare(port, ref, rtol=1e-6, atol=1e-7)
    assert float(port[1][0]) == float(yp[0])     # endpoints pinned
    assert float(port[1][-1]) == float(yp[-1])


@pytest.mark.parametrize("alpha", [-7.5, 0.0, 4.0, 12.0])
def test_rotate_about_quarter_chord(alpha):
    coords = naca4(2, 4, 12, 60).astype(np.float32)
    port, ref = run_both(jpan.rotate_about_quarter_chord,
                         tpan.rotate_about_quarter_chord, coords, alpha)
    compare(port, ref, rtol=1e-6, atol=1e-7)
