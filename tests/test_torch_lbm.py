"""The port's LBM (``airfoil_tpu_torch.lbm``) against the JAX reference.

Everything runs on the CPU with an explicit ``device="cpu"``; inputs are
made with numpy from a seed and handed to both packages. The CUDA kernel
itself cannot run here: its wrapper takes the plain torch step for a CPU
tensor, and ``chip_smoke.py`` holds the kernel to that step on the card.

Tolerances: the Pallas bar, rtol 1e-5 and atol 1e-6
(tests/test_lbm.py:166-167), for lattices and fields. CL and CD are
differences of two float32 sums of face pressures that are ~100x larger
than the result, so summing in another order moves them by a few float32
ulps of those sums (~2e-5 relative at 384x192): their bar is 4 ulps of the
summed pressures. The separation fraction counts sign tests of ux at the
wall, so its bar is in cells: at most 2 surface faces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.config import LBMConfig
from airfoil_tpu.lbm import core as jcore
from airfoil_tpu.lbm import diagnostics as jdiag
from airfoil_tpu.lbm import masks as jmasks
from airfoil_tpu.lbm.runner import WindTunnel as JaxWindTunnel
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.lbm import core, diagnostics, kernel, masks
from airfoil_tpu_torch.lbm.runner import WindTunnel

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"
SMALL = LBMConfig(nx=96, ny=48)
GRIDS = [SMALL, LBMConfig()]          # 96x48 and the served 384x192
EPS32 = float(np.finfo(np.float32).eps)


def _ids(cfg):
    return f"{cfg.nx}x{cfg.ny}"


def _mask(cfg, alpha=6.0):
    return jmasks.rasterize_airfoil(naca4(2, 4, 12, 40), alpha, cfg)


def _noisy_f(cfg, seed=0):
    """Freestream equilibrium with a seeded 1% perturbation."""
    rng = np.random.default_rng(seed)
    f = np.asarray(jcore.equilibrium_init(cfg.ny, cfg.nx, cfg.u0))
    noise = 1.0 + 0.01 * rng.standard_normal(f.shape)
    return (f * noise).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a), device=CPU)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


class TestCore:
    def test_constants(self):
        np.testing.assert_array_equal(core.D2Q9_E, jcore.D2Q9_E)
        np.testing.assert_array_equal(core.D2Q9_W, jcore.D2Q9_W)
        np.testing.assert_array_equal(core.D2Q9_OPP, jcore.D2Q9_OPP)

    @pytest.mark.parametrize("cfg", GRIDS, ids=_ids)
    def test_equilibrium_init(self, cfg):
        _close(core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, CPU),
               jcore.equilibrium_init(cfg.ny, cfg.nx, cfg.u0))

    def test_macro_fields(self):
        f = _noisy_f(SMALL, seed=1)
        for port, ref in zip(core.macro_fields(_t(f)),
                             jcore.macro_fields(jnp.asarray(f))):
            _close(port, ref)

    @pytest.mark.parametrize("cfg", GRIDS, ids=_ids)
    def test_boundary_masks(self, cfg):
        for port, ref in zip(core.boundary_masks(cfg.ny, cfg.nx, CPU),
                             jcore.boundary_masks(cfg.ny, cfg.nx)):
            np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

    def test_bounce_masks(self):
        rng = np.random.default_rng(2)
        for solid in (_mask(SMALL),
                      (rng.random((SMALL.ny, SMALL.nx)) > 0.7)
                      .astype(np.float32)):
            port = core.bounce_masks(_t(solid))
            ref = jcore.bounce_masks(jnp.asarray(solid))
            for p, r in zip(port, ref):
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))

    @pytest.mark.parametrize("cfg", GRIDS, ids=_ids)
    def test_lbm_step_trajectory(self, cfg):
        """1, 8, 64 and 400 steps of NACA 2412 at alpha=6 from a seeded
        perturbed freestream."""
        f0 = _noisy_f(cfg)
        solid = _mask(cfg)
        fj, ft = jnp.asarray(f0), _t(f0)
        sj, st = jnp.asarray(solid), _t(solid)
        done = 0
        for n in (1, 8, 64, 400):
            fj = jcore.lbm_step(fj, sj, cfg.u0, cfg.tau, steps=n - done)
            ft = core.lbm_step(ft, st, cfg.u0, cfg.tau, steps=n - done)
            done = n
            _close(ft, fj)
        assert torch.isfinite(ft).all()


class TestMasks:
    @pytest.mark.parametrize("alpha", [0.0, 6.0, 15.0])
    @pytest.mark.parametrize("cfg", GRIDS, ids=_ids)
    def test_build_mask_exact(self, cfg, alpha):
        coords = naca4(2, 4, 12, 60)
        mask, outline = masks.build_mask(coords, alpha, cfg)
        ref_mask, ref_outline = jmasks.build_mask(coords, alpha, cfg)
        assert mask.dtype == np.float32 and mask.sum() > 0
        np.testing.assert_array_equal(mask, ref_mask)
        np.testing.assert_array_equal(outline, ref_outline)


class TestKernelModule:
    def test_cpu_matches_pallas_interpret(self):
        """On a CPU tensor ``lbm_steps`` equals the Pallas kernel run in
        interpret mode (as tests/test_lbm.py:142-167 runs it), and the
        launch counter stays 0."""
        from functools import partial

        import jax
        import jax.experimental.pallas as pl
        import jax.experimental.pallas.tpu as pltpu
        from airfoil_tpu.lbm import kernel as K

        cfg = LBMConfig(nx=128, ny=32)
        solid = _mask(cfg)
        f0 = np.asarray(jcore.equilibrium_init(cfg.ny, cfg.nx, cfg.u0))
        scal = jnp.stack([jnp.float32(cfg.u0), jnp.float32(cfg.tau)])
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )
        ref = pl.pallas_call(
            partial(K._kernel, steps=8),
            out_shape=jax.ShapeDtypeStruct(f0.shape, f0.dtype),
            grid_spec=grid_spec,
            interpret=True,
        )(scal, jnp.asarray(f0), jnp.asarray(solid))

        before = kernel.launches
        out = kernel.lbm_steps(_t(f0), _t(solid), cfg.u0, cfg.tau, steps=8)
        assert kernel.launches == before
        assert out.device.type == "cpu" and out.dtype == torch.float32
        _close(out, ref)

    @pytest.mark.parametrize("bad", ["float64", "non_contiguous",
                                     "wrong_q", "solid_shape", "steps_0"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        cfg = LBMConfig(nx=32, ny=16)
        f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, CPU)
        solid = torch.zeros((cfg.ny, cfg.nx), dtype=torch.float32)
        steps = 2
        if bad == "float64":
            f = f.double()
        elif bad == "non_contiguous":
            f = f.transpose(1, 2).contiguous().transpose(1, 2)
            solid = solid.t().contiguous().t()
        elif bad == "wrong_q":
            f = f[:8].contiguous()
        elif bad == "solid_shape":
            solid = solid[:, :-1].contiguous()
        elif bad == "steps_0":
            steps = 0
        before = kernel.launches
        with pytest.raises((TypeError, ValueError)):
            kernel.lbm_steps(f, solid, cfg.u0, cfg.tau, steps=steps)
        assert kernel.launches == before


def _force_bar(f, solid, cfg):
    """4 float32 ulps of the summed face pressures, in units of CL."""
    rho = np.asarray(f, np.float64).sum(axis=0)
    is_solid = solid > 0.5
    total = 0.0
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        face = is_solid & ~np.roll(is_solid, (-dy, -dx), axis=(0, 1))
        total += np.roll(rho / 3.0, (-dy, -dx), axis=(0, 1))[face].sum()
    q = 0.5 * cfg.u0 * cfg.u0 * cfg.chord_cells
    return 4 * EPS32 * total / q


def _surface_faces(solid):
    is_solid = solid > 0.5
    return sum(int((is_solid & ~np.roll(is_solid, (-dy, -dx), axis=(0, 1)))
                   .sum())
               for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)))


class TestDiagnostics:
    @pytest.mark.parametrize("alpha", [6.0, 15.0])
    def test_same_f_after_200_steps(self, alpha):
        cfg = LBMConfig()
        solid = _mask(cfg, alpha)
        fj = jcore.lbm_step(jnp.asarray(_noisy_f(cfg)), jnp.asarray(solid),
                            cfg.u0, cfg.tau, steps=200)
        f = np.asarray(fj)

        ref = jdiag.forces_and_separation(fj, jnp.asarray(solid), cfg.u0,
                                          cfg.chord_cells)
        port = diagnostics.forces_and_separation(_t(f), _t(solid), cfg.u0,
                                                 cfg.chord_cells)
        bar = _force_bar(f, solid, cfg)
        assert abs(float(port[0]) - float(ref[0])) <= bar      # CL
        assert abs(float(port[1]) - float(ref[1])) <= bar      # CD
        surf = _surface_faces(solid)
        assert abs(float(port[2]) - float(ref[2])) * surf <= 2.0   # sep

        ref_fields = jdiag.render_fields(fj, jnp.asarray(solid), cfg.u0)
        port_fields = diagnostics.render_fields(_t(f), _t(solid), cfg.u0)
        for p, r in zip(port_fields, ref_fields):
            p, r = p.numpy(), np.asarray(r)
            np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
            np.testing.assert_array_equal(np.isnan(p), solid > 0.5)
            fluid = ~np.isnan(r)
            _close(p[fluid], r[fluid])


class TestWindTunnel:
    def test_carry_over_from_jax_state(self):
        """50 JAX frames, then the port continues from the JAX state; 10
        more frames on each side agree."""
        coords = naca4(2, 4, 12, 40)
        jwt = JaxWindTunnel(coords, cfg=SMALL, use_pallas=False)
        for _ in range(50):
            jwt.frame()
        js = jwt.state

        wt = WindTunnel(coords, cfg=SMALL, device=CPU)
        wt.load_state(np.asarray(js.f), np.asarray(js.solid), js.outline,
                      js.alpha, js.u0, js.step_count, jwt.cl_smooth,
                      jwt.cd_smooth, jwt.sep_smooth)
        for _ in range(10):
            ref = jwt.frame()
            out = wt.frame()
        assert out["step"] == ref["step"] == 60 * SMALL.steps_per_frame
        _close(wt.state.f, jwt.state.f)
        bar = _force_bar(np.asarray(jwt.state.f), np.asarray(js.solid), SMALL)
        assert abs(out["cl"] - ref["cl"]) <= bar
        assert abs(out["cd"] - ref["cd"]) <= bar
        assert out["alpha"] == ref["alpha"]
        assert out["reynolds"] == pytest.approx(ref["reynolds"])
        for k, v in out["fields"].items():
            assert v.shape == (SMALL.ny, SMALL.nx)
            np.testing.assert_array_equal(np.isnan(v.numpy()),
                                          np.isnan(ref["fields"][k]))

    def test_frames_and_alpha_change(self):
        wt = WindTunnel(naca4(2, 4, 12, 40), cfg=SMALL, device=CPU)
        for _ in range(30):
            out = wt.frame()
        assert np.isfinite(out["cl"]) and out["cd"] >= 0.0
        assert out["step"] == 30 * SMALL.steps_per_frame
        wt.set_alpha(12.0)
        out2 = wt.frame()
        assert out2["alpha"] == 12.0
        assert out2["fields"]["speed"].shape == (SMALL.ny, SMALL.nx)

    def test_load_state_rejects_wrong_shape(self):
        wt = WindTunnel(naca4(2, 4, 12, 40), cfg=SMALL, device=CPU)
        with pytest.raises(ValueError):
            wt.load_state(np.zeros((9, 8, 8), np.float32),
                          np.zeros((8, 8), np.float32), np.zeros((3, 2)),
                          0.0, SMALL.u0, 0)
