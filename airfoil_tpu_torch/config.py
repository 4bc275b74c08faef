"""Service limits, environment variables, and the solver and lattice
configurations.

A copy of ``airfoil_tpu/config.py``'s limits, environment variables and
configuration records (``SolverConfig``, ``LBMConfig``), with the same
names, values and environment variables: the port keeps its own
copies and imports nothing of the JAX package. ``tests/test_torch_isolation.py``
holds the two equal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# ── Input envelope ──────────────────────────────────────────────────────────
MAX_FILE_SIZE = 1 * 1024 * 1024  # 1 MB upload cap
MAX_POINTS = 500                 # max parsed coordinate points
MIN_POINTS = 10                  # min valid coordinate points
MIN_REYNOLDS = 1e4
MAX_REYNOLDS = 1e7
MIN_ALPHA = -10.0                # degrees (API bound)
MAX_ALPHA = 20.0

# ── Solver concurrency ──────────────────────────────────────────────────────
MAX_CONCURRENT_SOLVES = int(os.getenv("AIRFOIL_TPU_MAX_CONCURRENT", "3"))

# ── Environment ─────────────────────────────────────────────────────────────
ALLOWED_ORIGINS = os.getenv("ALLOWED_ORIGINS", "*").split(",")
PORT = int(os.getenv("PORT", "8000"))


@dataclass(frozen=True)
class SolverConfig:
    """Numerics configuration of the solver stack, the reference's defaults.
    ``n_panels`` matches the reference service's paneling density (XFOIL
    PANE gives ~140-160 nodes; the frontend vortex solver uses N=160)."""

    n_panels: int = 160          # surface panels (nodes = n_panels + 1)
    n_wake: int = 40             # wake stations for the viscous march
    newton_iters: int = 20       # viscous-inviscid coupling iterations
    station_newton_iters: int = 8  # per-station BL Newton iterations
    n_crit: float = 9.0          # e^N envelope amplification threshold
    dtype: str = "float32"


DEFAULT_SOLVER = SolverConfig()


@dataclass(frozen=True)
class LBMConfig:
    """D2Q9 lattice configuration: grid, relaxation time, inlet speed,
    steps per served frame, the physical domain and the stability clamps.
    The default 384x192 grid is the served one."""

    nx: int = 384
    ny: int = 192
    tau: float = 0.58
    u0: float = 0.06
    steps_per_frame: int = 4
    # physical domain
    dx0: float = -0.42
    dx1: float = 1.42
    dy0: float = -0.46
    dy1: float = 0.46
    # stability clamps
    u_max: float = 0.35
    rho_min: float = 0.5
    rho_max: float = 2.0

    @property
    def nu(self) -> float:
        return (self.tau - 0.5) / 3.0

    @property
    def chord_cells(self) -> float:
        return self.nx / (self.dx1 - self.dx0)


DEFAULT_LBM = LBMConfig()

# ── Served wind tunnel ──────────────────────────────────────────────────────
# The widths ``/lbm/start`` opens: the viewer's DEFAULT_LBM and the
# 2048 x 1024 large tunnel (ny is nx / 2, so cells stay square on the fixed
# 1.84 x 0.92 domain). A session steps ``lbm_steps_per_frame(nx)`` a frame.
LBM_WIDTHS = (384, 2048)


def lbm_steps_per_frame(nx: int) -> int:
    """Steps a frame of an ``nx``-wide session: the reference viewer's 4 at
    320 wide, scaled with the width so that a frame keeps its convective
    time, in whole rounds of 4 (the tiled kernel's): 4 at 384, 24 at
    2048."""
    return 4 * max(1, nx // 320)
