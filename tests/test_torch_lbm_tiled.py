"""The port's K-steps-per-launch LBM path against the JAX reference.

``lbm_steps_tiled`` is the counterpart of ``airfoil_tpu/lbm/kernel.py::
lbm_steps_pallas_tiled``; ``prefers_tiled`` and ``WindTunnel.tiled`` are
the counterparts of the JAX tunnel's resident-or-tiled selection. The CUDA
kernel cannot run here: on a CPU tensor the wrapper runs the plain torch
step, the full-grid step that the tiled kernel is defined to equal. The
JAX side runs the Pallas tiled kernel in interpret mode, as
tests/test_lbm.py:217-232 does. ``chip_smoke.py`` holds the CUDA kernel to
the plain step and, bit for bit, to ``lbm_steps`` on the card.

Tolerances: one kernel call is held to the Pallas tiled bar, rtol 1e-6 and
atol 1e-7 (tests/test_lbm.py:231-232); the tunnel to the bars of
tests/test_torch_lbm.py (lattice and fields rtol 1e-5, atol 1e-6; CL and CD
4 float32 ulps of the summed face pressures; separation 2 surface cells).
After 2 frames the two lattices differ by float32 rounding (~4e-7), so the
speed and Cp fields are compared in lattice units (|u| and rho), before
the division by U0 and 1.5 U0^2 that both packages apply alike.
"""

import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.config import LBMConfig
from airfoil_tpu.lbm.kernel import lbm_steps_pallas_tiled
from airfoil_tpu.lbm.runner import WindTunnel as JaxWindTunnel
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.lbm import core, kernel, runner
from airfoil_tpu_torch.lbm.runner import WindTunnel
from test_torch_lbm import (_close, _force_bar, _mask, _noisy_f,
                            _surface_faces, _t)

TILED = LBMConfig(nx=128, ny=96)      # three 32-row strips on the JAX side
H100_SMS, H100_SMEM = 132, 232_448    # SMs, opt-in shared memory per block


def _edge_solid(mask):
    """``mask`` plus solid cells on row 0, row NY-1, column 0 and the
    outlet column: edge cells that bounce from wrapped neighbours."""
    m = mask.copy()
    m[0, ::3] = 1.0
    m[-1, 1::3] = 1.0
    m[::3, 0] = 1.0
    m[::5, -1] = 1.0
    return m


class TestTiledKernelModule:
    @pytest.mark.parametrize("mask_kind", ["naca", "edge_solid"])
    def test_cpu_matches_pallas_tiled_interpret(self, mask_kind):
        """4 steps from a seeded perturbed freestream: on a CPU tensor
        ``lbm_steps_tiled`` equals the Pallas tiled kernel (3 strips,
        clamped edge windows), and its launch counter stays 0."""
        solid = _mask(TILED)
        if mask_kind == "edge_solid":
            solid = _edge_solid(solid)
        f0 = _noisy_f(TILED, seed=3)
        with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
            ref = lbm_steps_pallas_tiled(jnp.asarray(f0), jnp.asarray(solid),
                                         TILED.u0, TILED.tau, steps=4,
                                         tile_rows=32)
        out = kernel.lbm_steps_tiled(_t(f0), _t(solid), TILED.u0, TILED.tau,
                                     steps=4)
        assert kernel.tiled_launches == 0
        assert out.device.type == "cpu" and out.dtype == torch.float32
        _close(out, ref, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("bad", ["float64", "non_contiguous",
                                     "wrong_q", "solid_shape", "steps_0"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        cfg = LBMConfig(nx=32, ny=16)
        f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, "cpu")
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
        with pytest.raises((TypeError, ValueError)):
            kernel.lbm_steps_tiled(f, solid, cfg.u0, cfg.tau, steps=steps)
        assert kernel.tiled_launches == 0

    @pytest.mark.parametrize("nx,ny,tiled", [
        (384, 192, False),     # 2.65 MB: the served grid stays on kernel #1
        (640, 384, False),     # 8.8 MB: bench_mlups's default
        (880, 440, False),     # 13.9 MB: the largest 2:1 grid kernel #1 holds
        (880, 448, True),      # just past its capacity
        (1024, 512, True),     # 18.9 MB: two buffers exceed 132 x 227 KB
        (2048, 1024, True),    # 75 MB
        (4096, 2048, True),    # 302 MB
    ])
    def test_prefers_tiled(self, nx, ny, tiled):
        """Tiled exactly where ``lbm_steps`` cannot hold the lattice on an
        H100's SMs (``resident_plan`` finds no tiling)."""
        assert kernel.prefers_tiled(ny, nx, H100_SMS, H100_SMEM) is tiled
        assert (kernel.resident_plan(ny, nx, H100_SMS, H100_SMEM)
                is None) is tiled


class TestTiledWindTunnel:
    def test_cpu_resolves_to_the_one_step_path(self):
        for cfg in (TILED, LBMConfig(nx=2048, ny=1024)):
            wt = WindTunnel(naca4(2, 4, 12, 40), cfg=cfg, device="cpu")
            assert wt.tiled is False

    def test_matches_jax_tiled_tunnel(self, monkeypatch):
        """The JAX tunnel on its tiled Pallas path (interpret mode) and the
        port's ``tiled=True`` tunnel from the same state agree over 2
        frames, and the port's frames went through ``lbm_steps_tiled``."""
        coords = naca4(2, 4, 12, 40)
        jwt = JaxWindTunnel(coords, cfg=TILED, use_pallas=True, tiled=True)
        js = jwt.state
        wt = WindTunnel(coords, cfg=TILED, device="cpu", tiled=True)
        wt.load_state(np.asarray(js.f), np.asarray(js.solid), js.outline,
                      js.alpha, js.u0, js.step_count)

        calls = []

        def spy(*args, **kwargs):
            calls.append(kwargs["steps"])
            return kernel.lbm_steps_tiled(*args, **kwargs)

        monkeypatch.setattr(runner, "lbm_steps_tiled", spy)
        with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
            for _ in range(2):
                ref = jwt.frame()
        for _ in range(2):
            out = wt.frame()

        assert calls == [TILED.steps_per_frame] * 2
        assert kernel.tiled_launches == 0
        assert out["step"] == ref["step"] == 2 * TILED.steps_per_frame
        _close(wt.state.f, jwt.state.f)
        solid = np.asarray(js.solid)
        bar = _force_bar(np.asarray(jwt.state.f), solid, TILED)
        assert abs(out["cl"] - ref["cl"]) <= bar
        assert abs(out["cd"] - ref["cd"]) <= bar
        assert abs(out["separation"] - ref["separation"]) \
            * _surface_faces(solid) <= 2.0
        # Fields in lattice units, where the lattice's bar applies: speed is
        # |u|/U0 and Cp (rho-1)/(1.5 U0^2), so their normalisation alone
        # multiplies the lattice's float32 differences by ~17 and ~185.
        to_lattice = {"speed": lambda a: a * np.float32(TILED.u0),
                      "cp": lambda a: 1.0 + a * np.float32(
                          1.5 * TILED.u0 * TILED.u0)}
        for name, v in out["fields"].items():
            p, r = v.numpy(), np.asarray(ref["fields"][name])
            np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
            fluid = ~np.isnan(r)
            scale = to_lattice.get(name, lambda a: a)
            _close(scale(p[fluid]), scale(r[fluid]))
