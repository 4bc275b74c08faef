"""Service limits, environment variables and the lattice configuration.

A copy of the parts of ``airfoil_tpu/config.py`` that the port reads, with
the same names, values and environment variables: the port keeps its own
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
