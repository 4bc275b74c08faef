"""Transport-independent API handlers: the wind-tunnel sessions, the
single-point analysis (``/upload_airfoil/``), the polar sweep
(``/polar/``), the batch analysis (``/batch/``) and the analysis counter
(``/stats``).

Port of ``airfoil_tpu/api/handlers.py``. That module imports JAX at import
time, so its handlers are copied here with the same validation, rounding
and JSON keys; ``/health`` reports the torch device instead of a JAX
backend, and the solving handlers take the device to solve on.
``start_warmup`` builds the kernel libraries and captures the solver's
CUDA graphs in a background thread at server start. Handlers map parsed
inputs to ``(status_code, payload_dict)``; ``encode_reply`` writes a
payload as the reply's JSON bytes.
"""

from __future__ import annotations

import binascii
import dataclasses
import json
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
from airfoil_tpu_torch.utils.profiling import span
from airfoil_tpu_torch.utils.stats import (
    get_analysis_count,
    increment_analysis_count,
)

logger = logging.getLogger(__name__)

__all__ = [
    "ApiError", "parse_upload", "validate_envelope", "handle_root",
    "handle_health", "handle_upload", "handle_polar", "handle_batch",
    "handle_stats", "LBMSessions", "lbm_config", "start_warmup",
    "encode_reply",
]

# Replies ``encode_reply`` assembled around raw field bytes: one a frame.
raw_field_replies = 0
_COUNT_LOCK = threading.Lock()
# A bytes leaf's stand-in while the rest of a reply is dumped, and its
# JSON form in the dumped text.
_RAW = "\0"
_RAW_JSON = json.dumps(_RAW).encode()


class ApiError(Exception):
    def __init__(self, status_code: int, detail: str):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


def start_warmup(device=None) -> threading.Thread:
    """Build the kernels and capture the solver's graphs at the served
    shapes in a daemon thread named ``solver-warmup``, so that the first
    requests do not pay for them (the reference's warm-up of its XLA
    compiles): every kernel library (``enable_persistent_compile_cache``),
    the 32-point polar bucket's graphs (``warm_polar_kernels``), an
    alpha-14 analysis of NACA 2412 at Re 1e6 (the Newton, continuation and
    rescue keys of ``/upload_airfoil/``), then the one-lane direct solve
    at 160 panels that the analysis falls back to last
    (``analyze.warm_direct_solve``). Each stage's seconds are logged,
    and a failure is logged, not raised. A request that arrives meanwhile
    is served: it waits only for a capture of its own key, each capture
    leaves other threads' work alone (``viscous.graphs``). On ``device``
    (see ``resolve_device``). Returns the thread."""

    def _warm():
        try:
            from airfoil_tpu_torch.models import naca4
            from airfoil_tpu_torch.polar.analyze import (
                analyze_airfoil,
                warm_direct_solve,
            )
            from airfoil_tpu_torch.polar.sweep import warm_polar_kernels
            from airfoil_tpu_torch.utils.compile_cache import (
                enable_persistent_compile_cache,
            )

            t0 = time.perf_counter()
            enable_persistent_compile_cache()
            logger.info("kernel library warmup done in %.1fs",
                        time.perf_counter() - t0)
            t0 = time.perf_counter()
            warm_polar_kernels(p=32, device=device)
            logger.info("polar warmup done in %.1fs",
                        time.perf_counter() - t0)
            t0 = time.perf_counter()
            analyze_airfoil(naca4(2, 4, 12, 60), reynolds=1e6, alpha=14.0,
                            device=device)
            logger.info("analysis warmup done in %.1fs",
                        time.perf_counter() - t0)
            t0 = time.perf_counter()
            warm_direct_solve(device=device)
            logger.info("direct solve warmup done in %.1fs",
                        time.perf_counter() - t0)
        except Exception:            # noqa: BLE001 - warm-up is best-effort
            logger.exception("solver warmup failed")

    thread = threading.Thread(target=_warm, name="solver-warmup",
                              daemon=True)
    thread.start()
    return thread


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


def handle_polar(filename: str, content: bytes, reynolds: float,
                 alpha_start: float, alpha_end: float, alpha_step: float,
                 device=None):
    """``POST /polar/``: a whole polar on ``device`` (see
    ``resolve_device``), one strategy reported per point."""
    validate_envelope(reynolds, alpha_start)
    validate_envelope(reynolds, alpha_end)
    if not (0.1 <= alpha_step <= 5.0):
        raise ApiError(400, "alpha_step must be in [0.1, 5]")
    coords, parser_fixes = parse_upload(filename, content)
    alphas = np.arange(alpha_start, alpha_end + 1e-6, alpha_step,
                       dtype=np.float32)
    if len(alphas) > 128:
        raise ApiError(400, "Too many polar points (max 128)")

    from airfoil_tpu_torch.polar import solve_polar

    t0 = time.perf_counter()
    res = solve_polar(np.asarray(coords, np.float32), alphas, reynolds,
                      device=device)
    dt = time.perf_counter() - t0
    increment_analysis_count()
    # "viscous_smoothed" is the reference's Strategy 2 (GDES SMOO).
    mode_names = {0: "viscous", 1: "viscous_smoothed", 2: "inviscid"}
    return 200, {
        "success": True,
        "num_points": len(coords),
        "parser_fixes": parser_fixes,
        "reynolds": reynolds,
        "elapsed_seconds": round(dt, 4),
        "polar": [
            {
                "alpha": float(res.alpha[i]),
                "CL": round(float(res.cl[i]), 4),
                "CD": round(float(res.cd[i]), 6),
                "CDp": round(float(res.cdp[i]), 6),
                "Cm": round(float(res.cm[i]), 4),
                "mode": mode_names[int(res.mode[i])],
                "converged": bool(res.converged[i]),
                "xtr_upper": round(float(res.xtr_upper[i]), 4),
                "xtr_lower": round(float(res.xtr_lower[i]), 4),
                "sep_fraction": round(float(res.sep_fraction[i]), 4),
            }
            for i in range(len(alphas))
        ],
    }


def handle_batch(files: list, reynolds: float, alpha: float, device=None):
    """``POST /batch/``: at most 10 files, ``files`` a list of (filename,
    content) pairs, solved as the lanes of one batched solve on
    ``device``; a file that fails to parse gets an error row."""
    validate_envelope(reynolds, alpha)
    if not files:
        raise ApiError(400, "No files uploaded")
    if len(files) > 10:
        raise ApiError(400, "At most 10 files per batch")

    names, coords_list, fixes_list = [], [], []
    errors = {}
    for fname, content in files:
        try:
            coords, fixes = parse_upload(fname, content)
            names.append(fname)
            coords_list.append(np.asarray(coords, np.float32))
            fixes_list.append(fixes)
        except ApiError as e:
            errors[fname] = e.detail

    from airfoil_tpu_torch.polar import solve_batch

    t0 = time.perf_counter()
    rows = []
    if coords_list:
        res = solve_batch(coords_list, reynolds, alpha, device=device)
        for i, name in enumerate(names):
            rows.append({
                "file": name,
                "CL": round(float(res.cl[i]), 4),
                "CD": round(float(res.cd[i]), 6),
                "CDp": round(float(res.cdp[i]), 6),
                "Cm": round(float(res.cm[i]), 4),
                "converged": bool(res.converged[i]),
                "xtr_upper": round(float(res.xtr_upper[i]), 4),
                "xtr_lower": round(float(res.xtr_lower[i]), 4),
                "parser_fixes": fixes_list[i],
            })
            increment_analysis_count()
    dt = time.perf_counter() - t0
    for name, detail in errors.items():
        rows.append({"file": name, "error": detail})
    return 200, {
        "success": True,
        "reynolds": reynolds,
        "alpha": alpha,
        "elapsed_seconds": round(dt, 4),
        "results": rows,
    }


def handle_stats():
    return 200, {"total_analyses": get_analysis_count()}


def _b64_field(t: torch.Tensor) -> dict:
    """A field tensor copied to the host as float32, its ``data`` the
    base64 of the host buffer as ASCII bytes (``encode_reply`` writes them
    as a JSON string)."""
    a = np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)
    return {
        "shape": list(a.shape),
        "dtype": "float32",
        "data": binascii.b2a_base64(memoryview(a).cast("B"), newline=False),
    }


def encode_reply(payload) -> bytes:
    """``payload`` as the reply's body: ``json.dumps(payload).encode()``
    byte for byte, where each ``bytes`` leaf (ASCII that JSON writes as is,
    such as base64) stands for the str it spells. Those leaves are never
    dumped: the rest is, with a stand-in for each, and the raw bytes are
    joined in at the stand-ins. A payload without one is dumped as is.
    Raises ``ValueError`` where a str of a payload with such leaves is the
    stand-in."""
    raws = []

    def stand_in(o):
        if not isinstance(o, bytes):
            raise TypeError(f"Object of type {type(o).__name__} "
                            "is not JSON serializable")
        raws.append(o)
        return _RAW

    text = json.dumps(payload, default=stand_in).encode()
    if not raws:
        return text
    parts = text.split(_RAW_JSON)
    if len(parts) != len(raws) + 1:
        raise ValueError(f"a str of the reply dumps as {_RAW_JSON!r}, the "
                         "stand-in of its bytes")
    global raw_field_replies
    with _COUNT_LOCK:
        raw_field_replies += 1
    chunks = [parts[0]]
    for data, part in zip(raws, parts[1:]):
        chunks += (b'"', data, b'"', part)
    return b"".join(chunks)


def lbm_config(nx=None) -> config.LBMConfig:
    """The lattice of a new session: ``config.DEFAULT_LBM`` at the width
    ``nx`` that a request names (text or int; None or empty keeps the
    default), one of ``config.LBM_WIDTHS``, with ``ny = nx / 2`` and
    ``config.lbm_steps_per_frame(nx)`` steps a frame; else an ``ApiError``
    400."""
    if nx in (None, ""):
        return config.DEFAULT_LBM
    try:
        nx = int(nx)
    except (TypeError, ValueError):
        raise ApiError(400, "Field 'nx' must be an integer") from None
    if nx not in config.LBM_WIDTHS:
        raise ApiError(400, "nx must be one of "
                            f"{', '.join(map(str, config.LBM_WIDTHS))}, "
                            f"got {nx}")
    return dataclasses.replace(
        config.DEFAULT_LBM, nx=nx, ny=nx // 2,
        steps_per_frame=config.lbm_steps_per_frame(nx))


class LBMSessions:
    """Wind-tunnel session registry (thread-safe, bounded), serving every
    session on one device. A session's lattice is ``lbm_config``'s: the
    default 384 x 192 at 4 steps a frame, or 2048 x 1024 at 24; the tunnel
    steps it on the kernel that holds it (``WindTunnel``'s
    ``prefers_tiled``)."""

    def __init__(self, max_sessions: int = 8, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._tunnels: dict[str, object] = {}
        # Per-session locks: frame/set_alpha/set_u0 mutate WindTunnel state
        # (lattice, EMA smoothers, mask swap); two concurrent /lbm/frame
        # posts on one session would otherwise interleave or lose steps.
        self._session_locks: dict[str, threading.Lock] = {}
        self._max = max_sessions

    def start(self, filename: str, content: bytes, alpha: float, nx=None):
        """Open a session on the uploaded loop at ``alpha``, on the lattice
        of ``lbm_config(nx)``; its reply gives that lattice's ``grid``
        (ny, nx) and ``steps_per_frame``."""
        cfg = lbm_config(nx)
        coords, _fixes = parse_upload(filename, content)

        from airfoil_tpu_torch.lbm import WindTunnel

        wt = WindTunnel(np.asarray(coords, np.float64), cfg=cfg,
                        device=self.device)
        wt.set_alpha(alpha)
        session = str(uuid.uuid4())[:8]
        with self._lock:
            while len(self._tunnels) >= self._max:
                dropped = next(iter(self._tunnels))
                self._tunnels.pop(dropped)
                self._session_locks.pop(dropped, None)
            self._tunnels[session] = wt
            self._session_locks[session] = threading.Lock()
        return 200, {
            "session": session,
            "grid": [cfg.ny, cfg.nx],
            "domain": [cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1],
            "tau": cfg.tau,
            "u0": cfg.u0,
            "steps_per_frame": cfg.steps_per_frame,
        }

    def frame(self, session: str, alpha=None, u0=None, fields="speed"):
        """One frame of ``session``, traced as ``lbm.wait`` (the registry's
        and the session's locks), the tunnel's own spans and ``lbm.fields``
        (the fields' copies to the host and their base64)."""
        with span("lbm.wait"):
            with self._lock:
                wt = self._tunnels.get(session)
                slock = self._session_locks.get(session)
            if wt is None or slock is None:
                raise ApiError(404, "Unknown session")
            slock.acquire()
        try:
            if alpha is not None and abs(alpha - wt.state.alpha) > 1e-6:
                wt.set_alpha(alpha)
            if u0 is not None:
                wt.set_u0(u0)
            out = wt.frame()
        finally:
            slock.release()
        want = set(fields.split(","))
        with span("lbm.fields"):
            encoded = {k: _b64_field(v) for k, v in out["fields"].items()
                       if k in want}
        return 200, {
            "cl": round(out["cl"], 4),
            "cd": round(out["cd"], 4),
            "separation": round(out["separation"], 4),
            "reynolds": round(out["reynolds"], 1),
            "step": out["step"],
            "alpha": out["alpha"],
            "fields": encoded,
            "outline": np.asarray(out["outline"],
                                  np.float64).round(5).tolist(),
        }

    def stop(self, session: str):
        with self._lock:
            self._tunnels.pop(session, None)
            self._session_locks.pop(session, None)
        return 200, {"stopped": session}
