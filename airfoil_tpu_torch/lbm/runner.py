"""Server-side wind tunnel: state management and per-frame stepping.

Port of ``airfoil_tpu/lbm/runner.py`` with an explicit ``device``. A frame
is one ``lbm_steps`` or ``lbm_steps_tiled`` call (one CUDA kernel launch on
a CUDA device; the plain torch step on the CPU) followed by the
force/separation reductions and the render fields (``frame_fields``: one
CUDA graph replay a frame on the card). The lattice stays on
the device; only three scalars are read back per frame, and the fields are
tensors until the API layer converts them. The static cell word the
kernels read is built with the mask, at ``reset``, ``set_alpha`` and
``load_state``, and never in a frame. A frame is traced as the
``utils.profiling.span`` ``lbm.frame`` around ``lbm.step`` and
``lbm.diagnostics``, a slider move as ``lbm.remask``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from airfoil_tpu_torch.config import LBMConfig, DEFAULT_LBM
from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.lbm.core import equilibrium_init
from airfoil_tpu_torch.lbm.diagnostics import frame_fields
from airfoil_tpu_torch.lbm.kernel import (cell_word, device_limits,
                                          lbm_steps, lbm_steps_tiled,
                                          prefers_tiled)
from airfoil_tpu_torch.lbm.masks import build_mask
from airfoil_tpu_torch.utils.profiling import span

__all__ = ["LBMState", "WindTunnel"]


@dataclass
class LBMState:
    f: torch.Tensor
    solid: torch.Tensor
    word: torch.Tensor        # kernel.cell_word(solid)
    outline: np.ndarray
    alpha: float
    u0: float
    step_count: int = 0


@dataclass
class WindTunnel:
    """One simulation session (one uploaded geometry).

    EMA smoothing of CL/CD (0.9/0.1) and separation (0.85/0.15) as in the
    reference. ``device`` is resolved by ``device.resolve_device``: it
    raises for ``cuda`` without a CUDA device.

    ``tiled`` picks the step kernel, as the JAX tunnel's ``tiled`` does:
    left ``None``, it resolves on a CUDA device by ``prefers_tiled`` on the
    card's SM count and shared memory (``lbm_steps`` while it can hold the
    lattice on chip, the K-steps-per-launch kernel beyond), and to
    ``False`` on the CPU. ``tiled=True`` on the CPU runs the plain step through
    ``lbm_steps_tiled``.
    """

    coords: np.ndarray
    cfg: LBMConfig = field(default_factory=lambda: DEFAULT_LBM)
    device: str | torch.device | None = None
    state: LBMState | None = None
    cl_smooth: float | None = None
    cd_smooth: float | None = None
    sep_smooth: float = 0.0
    tiled: bool | None = None

    def __post_init__(self):
        self.coords = np.asarray(self.coords, np.float64)
        self.device = resolve_device(self.device)
        if self.tiled is None:
            self.tiled = self.device.type == "cuda" and prefers_tiled(
                self.cfg.ny, self.cfg.nx, *device_limits(self.device))
        self.reset(alpha=6.0, u0=self.cfg.u0)

    def _mask(self, mask: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The solid mask on the device and its cell word."""
        solid = torch.tensor(mask, dtype=DTYPE, device=self.device)
        return solid, cell_word(solid)

    def reset(self, alpha: float, u0: float | None = None):
        u0 = self.cfg.u0 if u0 is None else u0
        mask, outline = build_mask(self.coords, alpha, self.cfg)
        f = equilibrium_init(self.cfg.ny, self.cfg.nx, u0, self.device)
        solid, word = self._mask(mask)
        self.state = LBMState(f=f, solid=solid, word=word, outline=outline,
                              alpha=alpha, u0=u0)
        self.cl_smooth = None
        self.cd_smooth = None
        self.sep_smooth = 0.0

    def load_state(self, f, solid, outline, alpha: float, u0: float,
                   step_count: int, cl_smooth: float | None = None,
                   cd_smooth: float | None = None, sep_smooth: float = 0.0):
        """Continue from a mid-run state given as numpy arrays (for example
        ``np.asarray`` of a JAX ``LBMState``), smoothers included."""
        f = np.asarray(f, np.float32)
        solid = np.asarray(solid, np.float32)
        shape = (9, self.cfg.ny, self.cfg.nx)
        if f.shape != shape or solid.shape != shape[1:]:
            raise ValueError(f"state shapes {f.shape}/{solid.shape} do not "
                             f"match the {shape} lattice")
        solid, word = self._mask(solid)
        self.state = LBMState(
            f=torch.tensor(f, dtype=DTYPE, device=self.device),
            solid=solid, word=word, outline=np.asarray(outline, np.float64),
            alpha=float(alpha), u0=float(u0), step_count=int(step_count))
        self.cl_smooth = cl_smooth
        self.cd_smooth = cd_smooth
        self.sep_smooth = sep_smooth

    def set_alpha(self, alpha: float):
        """Re-rasterise the mask, keep the flow state."""
        with span("lbm.remask"):
            st = self.state
            mask, outline = build_mask(self.coords, alpha, self.cfg)
            st.solid, st.word = self._mask(mask)
            st.outline = outline
            st.alpha = alpha

    def set_u0(self, u0: float):
        self.state.u0 = float(u0)

    def frame(self, steps: int | None = None) -> dict:
        """Advance one frame; return stats + field tensors."""
        with span("lbm.frame"):
            return self._frame(steps)

    def _frame(self, steps: int | None) -> dict:
        st = self.state
        steps = self.cfg.steps_per_frame if steps is None else steps
        step = lbm_steps_tiled if self.tiled else lbm_steps
        with span("lbm.step"):
            st.f = step(st.f, st.solid, st.u0, self.cfg.tau, steps=steps,
                        word=st.word)
        st.step_count += steps

        with span("lbm.diagnostics"):
            cl, cd, sep, speed, cp, vort, ux, uy = frame_fields(
                st.f, st.solid, st.u0, self.cfg.chord_cells)
            cl, cd, sep = torch.stack([cl, cd, sep]).tolist()
        self.cl_smooth = cl if self.cl_smooth is None else \
            0.9 * self.cl_smooth + 0.1 * cl
        self.cd_smooth = cd if self.cd_smooth is None else \
            0.9 * self.cd_smooth + 0.1 * cd
        self.sep_smooth = 0.85 * self.sep_smooth + 0.15 * sep
        return {
            "cl": self.cl_smooth,
            "cd": max(self.cd_smooth, 0.0),
            "separation": self.sep_smooth,
            "reynolds": st.u0 * self.cfg.chord_cells / self.cfg.nu,
            "step": st.step_count,
            "alpha": st.alpha,
            "fields": {
                "speed": speed, "cp": cp, "vorticity": vort,
                "ux": ux, "uy": uy,
            },
            "outline": st.outline,
        }
