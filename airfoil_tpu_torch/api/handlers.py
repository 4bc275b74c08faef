"""Transport-independent API handlers: the wind-tunnel sessions and the
single-point analysis (``/upload_airfoil/``).

Port of the parts of ``airfoil_tpu/api/handlers.py`` that those routes
need. That module imports JAX at import time, so ``ApiError``,
``parse_upload``, ``validate_envelope``, ``_write_run_log`` and
``handle_upload`` are copied here; ``/health`` reports the torch device
instead of a JAX backend, and ``handle_upload`` takes the device to solve
on. ``start_warmup`` is not ported: it warms the reference's XLA compiles,
and the port compiles nothing ahead (its CUDA libraries build at first
use). Handlers map parsed inputs to ``(status_code, payload_dict)``.
"""

from __future__ import annotations

import base64
import logging
import os
import tempfile
import threading
import time
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
from airfoil_tpu_torch.utils.stats import increment_analysis_count

logger = logging.getLogger(__name__)

__all__ = [
    "ApiError", "parse_upload", "validate_envelope", "handle_root",
    "handle_health", "handle_upload", "LBMSessions",
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


def _write_run_log(run_id: str, filename: str, reynolds: float,
                   alpha: float, n_coords: int, parser_fixes: list,
                   result, elapsed: float):
    """Per-run solver artifact, the reference's ``xfoil_output.log``
    analog (reference main.py:404-415). One file per request under
    AIRFOIL_TPU_RUN_LOG_DIR (default ``airfoil_tpu_runs`` in the temporary
    directory; set empty to disable); best-effort, bounded to the newest
    ~200 files."""
    log_dir = os.environ.get("AIRFOIL_TPU_RUN_LOG_DIR",
                             os.path.join(tempfile.gettempdir(),
                                          "airfoil_tpu_runs"))
    if not log_dir:
        return
    try:
        os.makedirs(log_dir, exist_ok=True)
        entries = sorted(os.listdir(log_dir))
        for stale in entries[:-200]:
            try:
                os.unlink(os.path.join(log_dir, stale))
            except OSError:
                pass
        path = os.path.join(
            log_dir, f"{time.strftime('%Y%m%d-%H%M%S')}_{run_id}.log")
        with open(path, "w") as f:
            f.write(f"run_id: {run_id}\nfile: {filename}\n"
                    f"reynolds: {reynolds:g}\nalpha: {alpha:g}\n"
                    f"n_coords: {n_coords}\n"
                    f"elapsed_seconds: {elapsed:.3f}\n"
                    f"mode: {result.mode}\nstrategy: {result.strategy}\n"
                    f"converged: {result.converged}\n"
                    f"sep_fraction: {result.sep_fraction:.4f}\n"
                    f"coefficients: {result.coefficients}\n"
                    f"parser_fixes:\n")
            for fix in parser_fixes:
                f.write(f"  - {fix}\n")
            if result.extras:
                f.write(f"extras: {result.extras}\n")
    except Exception as e:           # pragma: no cover - never block a reply
        logger.warning("run log write failed: %s", e)


def handle_upload(filename: str, content: bytes,
                  reynolds: float, alpha: float, device=None):
    """``POST /upload_airfoil/``: validate, parse, ``analyze_airfoil`` on
    ``device`` (see ``resolve_device``), log the run, count it, and answer
    with the reference's schema (main.py:605-615)."""
    validate_envelope(reynolds, alpha)
    coords, parser_fixes = parse_upload(filename, content)
    run_id = str(uuid.uuid4())[:8]
    logger.info("request %s: %s Re=%g alpha=%g (%d pts)",
                run_id, filename, reynolds, alpha, len(coords))

    from airfoil_tpu_torch.polar import analyze_airfoil

    t0 = time.perf_counter()
    result = analyze_airfoil(coords, reynolds, alpha, device=device)
    elapsed = time.perf_counter() - t0
    logger.info("request %s done in %.3fs (mode=%s strategy=%d)",
                run_id, elapsed, result.mode, result.strategy)
    _write_run_log(run_id, filename, reynolds, alpha, len(coords),
                   parser_fixes, result, elapsed)
    # Result-sanity warnings (reference main.py:499-502 logs the same two
    # checks): a viscous CD below the flat-plate floor at this Re, or an
    # implausibly high L/D, usually means a wrong-basin solve slipped
    # through the convergence gates.
    c = result.coefficients
    cd_v = c.get("CD") or 0.0
    cl_v = c.get("CL") or 0.0
    if result.mode == "viscous" and reynolds > 1e5 and 0 < cd_v < 0.005:
        logger.warning("request %s: CD=%.6f suspiciously low "
                       "(expected ~0.007-0.012 at this Re)", run_id, cd_v)
    if cd_v > 0 and abs(cl_v) / cd_v > 150:
        logger.warning("request %s: L/D=%.0f unusually high",
                       run_id, abs(cl_v) / cd_v)
    increment_analysis_count()
    return 200, {
        "success": True,
        "coords_before": coords,
        "coords_after": coords,
        "num_points": len(coords),
        "cp_x": result.cp_x,
        "cp_values": result.cp_values,
        "coefficients": result.coefficients,
        "bl_data": result.bl_data,
        "parser_fixes": parser_fixes,
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
