"""Transport-independent API handlers for the wind-tunnel service.

Port of the parts of ``airfoil_tpu/api/handlers.py`` that the ``/lbm/*``
path needs. That module imports JAX at import time, so ``ApiError``,
``parse_upload`` and ``validate_envelope`` are copied here; ``/health``
reports the torch device instead of a JAX backend. Handlers map parsed
inputs to ``(status_code, payload_dict)``.
"""

from __future__ import annotations

import base64
import threading
import uuid

import numpy as np
import torch

from airfoil_tpu_torch import config
from airfoil_tpu_torch.geometry import (
    AirfoilParseError,
    is_multi_element,
    parse_dat_text,
)
from airfoil_tpu_torch.device import resolve_device

__all__ = [
    "ApiError", "parse_upload", "validate_envelope", "handle_root",
    "handle_health", "LBMSessions",
]


class ApiError(Exception):
    def __init__(self, status_code: int, detail: str):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


def parse_upload(filename: str, content: bytes):
    """Shared validation + parse path for any endpoint taking a .dat file."""
    if len(content) > config.MAX_FILE_SIZE:
        raise ApiError(400, f"File too large (max "
                            f"{config.MAX_FILE_SIZE / (1024 * 1024)}MB)")
    if not filename.endswith(".dat"):
        raise ApiError(400, "Only .dat files accepted")
    try:
        coords, fixes = parse_dat_text(
            content.decode("utf-8", errors="ignore"))
    except AirfoilParseError as e:
        raise ApiError(e.status_code, e.detail)
    if len(coords) > config.MAX_POINTS:
        raise ApiError(400, f"Too many points (max {config.MAX_POINTS})")
    if is_multi_element(coords):
        raise ApiError(400, "Multi-element airfoil detected — "
                            "single-element analysis only")
    return coords, fixes


def validate_envelope(reynolds: float, alpha: float):
    if not (config.MIN_REYNOLDS <= reynolds <= config.MAX_REYNOLDS):
        raise ApiError(400, f"Reynolds must be {config.MIN_REYNOLDS:,.0f} "
                            f"to {config.MAX_REYNOLDS:,.0f}")
    if not (config.MIN_ALPHA <= alpha <= config.MAX_ALPHA):
        raise ApiError(400, f"Alpha must be {config.MIN_ALPHA:.0f} to "
                            f"{config.MAX_ALPHA:.0f} degrees")


def handle_root():
    return 200, {"status": "ok", "service": "Airfoil TPU CFD API"}


def handle_health(device: torch.device):
    """Health with the serving device: its type and, for CUDA, its name."""
    on_cuda = device.type == "cuda"
    return 200, {
        "status": "healthy",
        "solver": "airfoil_tpu_torch",
        "backend": device.type,
        "accelerator": on_cuda,
        "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
    }


def _b64_field(t: torch.Tensor) -> dict:
    """A field tensor copied to the host as base64 float32 bytes."""
    a = np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)
    return {
        "shape": list(a.shape),
        "dtype": "float32",
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


class LBMSessions:
    """Wind-tunnel session registry (thread-safe, bounded), serving every
    session on one device."""

    def __init__(self, max_sessions: int = 8, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._tunnels: dict[str, object] = {}
        # Per-session locks: frame/set_alpha/set_u0 mutate WindTunnel state
        # (lattice, EMA smoothers, mask swap); two concurrent /lbm/frame
        # posts on one session would otherwise interleave or lose steps.
        self._session_locks: dict[str, threading.Lock] = {}
        self._max = max_sessions

    def start(self, filename: str, content: bytes, alpha: float):
        coords, _fixes = parse_upload(filename, content)

        from airfoil_tpu_torch.lbm import WindTunnel

        wt = WindTunnel(np.asarray(coords, np.float64), device=self.device)
        wt.set_alpha(alpha)
        session = str(uuid.uuid4())[:8]
        with self._lock:
            while len(self._tunnels) >= self._max:
                dropped = next(iter(self._tunnels))
                self._tunnels.pop(dropped)
                self._session_locks.pop(dropped, None)
            self._tunnels[session] = wt
            self._session_locks[session] = threading.Lock()
        cfg = wt.cfg
        return 200, {
            "session": session,
            "grid": [cfg.ny, cfg.nx],
            "domain": [cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1],
            "tau": cfg.tau,
            "u0": cfg.u0,
        }

    def frame(self, session: str, alpha=None, u0=None, fields="speed"):
        with self._lock:
            wt = self._tunnels.get(session)
            slock = self._session_locks.get(session)
        if wt is None or slock is None:
            raise ApiError(404, "Unknown session")
        with slock:
            if alpha is not None and abs(alpha - wt.state.alpha) > 1e-6:
                wt.set_alpha(alpha)
            if u0 is not None:
                wt.set_u0(u0)
            out = wt.frame()
        want = set(fields.split(","))
        return 200, {
            "cl": round(out["cl"], 4),
            "cd": round(out["cd"], 4),
            "separation": round(out["separation"], 4),
            "reynolds": round(out["reynolds"], 1),
            "step": out["step"],
            "alpha": out["alpha"],
            "fields": {k: _b64_field(v) for k, v in out["fields"].items()
                       if k in want},
            "outline": np.asarray(out["outline"],
                                  np.float64).round(5).tolist(),
        }

    def stop(self, session: str):
        with self._lock:
            self._tunnels.pop(session, None)
            self._session_locks.pop(session, None)
        return 200, {"stopped": session}
