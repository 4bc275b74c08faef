"""The static cell word and the resident kernel's tiling, on the CPU.

``core.cell_word`` packs the bounce masks and the boundary roles that both
CUDA LBM kernels read per cell; it is held element for element to the JAX
reference's ``bounce_masks`` and ``boundary_masks``. ``resident_plan`` is
the tiling ``lbm_steps`` runs a lattice with (one block per SM): every cell
lies in exactly one tile, and the tiles form a torus, so that the ring of
the first tile in a row or column is the last tile's edge. The wind tunnel
builds the word with the mask and never in a frame. ``chip_smoke.py``
holds the word kernel to ``core.cell_word`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.config import LBMConfig
from airfoil_tpu.lbm import core as jcore
from airfoil_tpu.lbm import masks as jmasks
from airfoil_tpu.lbm.runner import WindTunnel as JaxWindTunnel
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.lbm import core, kernel, runner
from airfoil_tpu_torch.lbm.runner import WindTunnel
from test_torch_lbm import _close, _noisy_f
from test_torch_lbm_tiled import H100_SMEM, H100_SMS, _edge_solid


def _naca(nx, ny):
    return jmasks.rasterize_airfoil(naca4(2, 4, 12, 60), 6.0,
                                    LBMConfig(nx=nx, ny=ny))


class TestCellWord:
    @pytest.mark.parametrize("mask_kind", ["naca", "edge_solid"])
    @pytest.mark.parametrize("nx,ny", [(24, 12), (128, 32), (1000, 600)])
    def test_matches_jax_masks(self, nx, ny, mask_kind):
        solid = _naca(nx, ny)
        if mask_kind == "edge_solid":
            solid = _edge_solid(solid)
        word = kernel.cell_word(torch.tensor(solid))
        assert word.dtype == torch.uint16 and word.shape == (ny, nx)
        assert kernel.word_launches == 0
        bits = word.to(torch.int32).numpy()
        for i, ref in enumerate(jcore.bounce_masks(jnp.asarray(solid))):
            np.testing.assert_array_equal((bits >> i) & 1, np.asarray(ref))
        is_outlet, is_edge_eq = jcore.boundary_masks(ny, nx)
        np.testing.assert_array_equal((bits >> core.OUTLET_BIT) & 1,
                                      np.asarray(is_outlet))
        np.testing.assert_array_equal((bits >> core.EDGE_BIT) & 1,
                                      np.asarray(is_edge_eq))
        assert not (bits >> 11).any()

    @pytest.mark.parametrize("bad", ["dtype", "shape", "device",
                                     "non_contiguous"])
    @pytest.mark.parametrize("step", ["lbm_steps", "lbm_steps_tiled"])
    def test_wrappers_refuse_a_bad_word(self, step, bad):
        cfg = LBMConfig(nx=32, ny=16)
        f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, "cpu")
        solid = torch.zeros((cfg.ny, cfg.nx), dtype=torch.float32)
        word = core.cell_word(solid)
        if bad == "dtype":
            word = word.to(torch.int16)
        elif bad == "shape":
            word = word[:, :-1].contiguous()
        elif bad == "device":
            word = torch.empty(word.shape, dtype=torch.uint16, device="meta")
        elif bad == "non_contiguous":
            word = core.cell_word(solid.t().contiguous()).t()
        before = (kernel.launches, kernel.tiled_launches, kernel.word_launches)
        with pytest.raises((TypeError, ValueError)):
            getattr(kernel, step)(f, solid, cfg.u0, cfg.tau, steps=2,
                                  word=word)
        assert (kernel.launches, kernel.tiled_launches,
                kernel.word_launches) == before

    def test_cpu_step_with_a_word_is_the_plain_step(self):
        cfg = LBMConfig(nx=64, ny=32)
        f0 = torch.tensor(_noisy_f(cfg, seed=5))
        solid = torch.tensor(_naca(cfg.nx, cfg.ny))
        want = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps=3)
        for step in (kernel.lbm_steps, kernel.lbm_steps_tiled):
            got = step(f0, solid, cfg.u0, cfg.tau, steps=3,
                       word=kernel.cell_word(solid))
            assert torch.equal(got, want)


class TestResidentPlan:
    @pytest.mark.parametrize("sm_count,smem", [(H100_SMS, H100_SMEM),
                                               (16, 232_448), (7, 100_000)])
    @pytest.mark.parametrize("nx,ny", [(24, 12), (128, 32), (384, 192),
                                       (640, 384), (880, 440), (1000, 37),
                                       (5, 3)])
    def test_tiles_cover_every_cell_once(self, nx, ny, sm_count, smem):
        plan = kernel.resident_plan(ny, nx, sm_count, smem)
        if plan is None:
            assert ny * nx * 72 > sm_count * smem * 0.9
            return
        assert plan.blocks <= sm_count
        assert plan.smem_bytes <= smem
        assert plan.tile_w * plan.tile_h <= (kernel.RESIDENT_THREADS
                                             * kernel.CELLS_PER_THREAD)
        count = np.zeros((ny, nx), np.int32)
        for y0, x0, h, w in plan.tiles(ny, nx):
            assert h >= 1 and w >= 1
            count[y0:y0 + h, x0:x0 + w] += 1
        np.testing.assert_array_equal(count, 1)

    @pytest.mark.parametrize("nx,ny", [(24, 12), (128, 32), (384, 192),
                                       (1000, 37)])
    def test_tiles_form_a_torus(self, nx, ny):
        """Each ring cell of a tile, taken modulo NY and NX, is an edge
        cell of the neighbouring tile that the kernel reads it from
        (tile indices modulo the tile grid), with that tile's own extent."""
        plan = kernel.resident_plan(ny, nx, H100_SMS, H100_SMEM)
        tiles = plan.tiles(ny, nx)
        for b, (y0, x0, h, w) in enumerate(tiles):
            by, bx = divmod(b, plan.tiles_x)
            for ly, lx in ([(-1, x) for x in range(-1, w + 1)]
                           + [(h, x) for x in range(-1, w + 1)]
                           + [(y, -1) for y in range(h)]
                           + [(y, w) for y in range(h)]):
                dy = -1 if ly < 0 else (1 if ly >= h else 0)
                dx = -1 if lx < 0 else (1 if lx >= w else 0)
                nb = ((by + dy) % plan.tiles_y) * plan.tiles_x \
                    + (bx + dx) % plan.tiles_x
                ny0, nx0, nh, nw = tiles[nb]
                qy = nh - 1 if dy < 0 else (0 if dy > 0 else ly)
                qx = nw - 1 if dx < 0 else (0 if dx > 0 else lx)
                assert (ny0 + qy, nx0 + qx) == ((y0 + ly) % ny,
                                                (x0 + lx) % nx)

    def test_exchange_is_two_surfaces_of_every_edge(self):
        plan = kernel.resident_plan(192, 384, H100_SMS, H100_SMEM)
        assert plan.exchange_floats == (2 * plan.blocks * 9
                                        * 2 * (plan.tile_w + plan.tile_h))


class TestWindTunnelWord:
    def test_word_built_with_the_mask_only(self, monkeypatch):
        """The word is built at reset, set_alpha and load_state, never in a
        frame, and every frame passes it to the step kernel."""
        built, passed = [], []

        def spy_word(solid):
            built.append(solid)
            return kernel.cell_word(solid)

        def spy_step(*args, word=None, **kwargs):
            passed.append(word)
            return kernel.lbm_steps(*args, word=word, **kwargs)

        monkeypatch.setattr(runner, "cell_word", spy_word)
        monkeypatch.setattr(runner, "lbm_steps", spy_step)
        cfg = LBMConfig(nx=64, ny=32)
        wt = WindTunnel(naca4(2, 4, 12, 40), cfg=cfg, device="cpu")
        assert len(built) == 1                           # reset
        wt.frame()
        wt.frame()
        assert len(built) == 1
        wt.set_alpha(10.0)
        assert len(built) == 2 and built[-1] is wt.state.solid
        wt.frame()
        st = wt.state
        wt.load_state(st.f.numpy(), st.solid.numpy(), st.outline, st.alpha,
                      st.u0, st.step_count)
        assert len(built) == 3
        wt.frame()
        wt.reset(alpha=2.0)
        assert len(built) == 4
        assert len(passed) == 4
        assert all(w is not None for w in passed)
        assert torch.equal(wt.state.word, core.cell_word(wt.state.solid))

    def test_frames_after_set_alpha_match_jax(self):
        """After an alpha change the port's frames (with the word rebuilt)
        equal the JAX tunnel's."""
        cfg = LBMConfig(nx=96, ny=48)
        coords = naca4(2, 4, 12, 40)
        jwt = JaxWindTunnel(coords, cfg=cfg, use_pallas=False)
        wt = WindTunnel(coords, cfg=cfg, device="cpu")
        for t in (jwt, wt):
            t.frame()
            t.set_alpha(12.0)
            out = t.frame()
        _close(wt.state.f, jwt.state.f)
        assert out["alpha"] == 12.0
