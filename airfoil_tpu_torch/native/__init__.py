"""Native (C++) geometry hot paths: the ``.dat`` parser and the scanline
mask.

Port of ``airfoil_tpu/native``: ``fastgeo.cpp`` is a byte copy of the
reference's source, bound through ctypes with the reference's signatures
and fix-message contract. The library is built with ``g++`` at first use
into ``airfoil_tpu_torch/_build/`` (git-ignored) by ``cuda_build``'s
rule: under a file lock, written to a temporary name and renamed into
place, rebuilt when the source is newer or the flags changed, never at
import time.

Without ``g++`` there is no native path: ``native_available()`` is False
and the entry points return None, so callers take their Python path. With
``g++`` present, a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from airfoil_tpu_torch import cuda_build

__all__ = ["get_lib", "native_available", "parse_dat_native",
           "raster_mask_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastgeo.cpp")
# -ffp-contract=off: the scanline's crossings round as numpy's do on any
# host (an fma would change a crossing by an ulp where g++ may fuse).
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]
_LOCK = threading.Lock()
_LIB = None

FIX_LEDNICER = 1
FIX_LE_DEDUP = 2
FIX_WINDING = 4


def _gxx() -> str:
    return shutil.which("g++")


def get_lib():
    """Load (building if needed) the native library; None without g++."""
    global _LIB
    with _LOCK:
        if _LIB is not None or _gxx() is None:
            return _LIB
        lib = ctypes.CDLL(cuda_build.build_library(
            "fastgeo", _gxx, GXX_FLAGS, [_SRC], headers=[]))
        lib.parse_dat.restype = ctypes.c_int32
        lib.parse_dat.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.raster_mask.restype = None
        lib.raster_mask.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def parse_dat_native(text: str):
    """Native .dat parse; returns (coords, fixes) with the reference's
    fix-message contract, or None when the native library is unavailable
    (caller falls back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode("utf-8", errors="ignore")
    max_out = 4096
    out = np.empty((max_out, 2), np.float64)
    counters = (ctypes.c_int32 * 5)()
    n = lib.parse_dat(
        raw, len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_out, counters)
    if n < 0:
        from airfoil_tpu_torch.geometry.parser import AirfoilParseError

        n_valid = -n - 1
        raise AirfoilParseError(
            f"Insufficient valid coordinates. Found {n_valid} points.",
            code="too_few_points")
    skipped_non_coord, skipped_range, flags, n_up, n_lo = (
        counters[0], counters[1], counters[2], counters[3], counters[4])
    coords = [[float(x), float(y)] for x, y in out[:n]]

    fixes = []
    if skipped_non_coord:
        fixes.append(
            f"Non-coordinate lines skipped: {skipped_non_coord} "
            f"header/comment line(s) removed")
    if skipped_range:
        fixes.append(
            f"Out-of-range points filtered: {skipped_range} "
            f"point(s) outside valid bounds removed")
    if flags & FIX_LEDNICER:
        fixes.append(
            f"Lednicer format detected and converted: two-section format "
            f"({n_up} upper + {n_lo} lower points) merged into "
            f"a single Selig-format loop for XFOIL")
    if flags & FIX_LE_DEDUP:
        fixes.append(
            "Duplicate leading-edge point removed from Lednicer lower section")
    if flags & FIX_WINDING:
        fixes.append(
            "Winding order corrected: coordinates were in reversed order "
            "(TE→lower→LE→upper→TE) and have been reversed to the correct "
            "Selig order (TE→upper→LE→lower→TE)")
    if not fixes:
        fixes = ["No changes made — file was already in valid Selig format"]
    return coords, fixes


def raster_mask_native(xp, yp, nx: int, ny: int, domain) -> np.ndarray | None:
    """Native scanline rasterisation of the float64 loop ``(xp, yp)`` onto
    an ``(ny, nx)`` float32 mask over ``domain`` ``(dx0, dx1, dy0, dy1)``;
    None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xp = np.ascontiguousarray(xp, np.float64)
    yp = np.ascontiguousarray(yp, np.float64)
    mask = np.zeros((ny, nx), np.float32)
    dx0, dx1, dy0, dy1 = domain
    lib.raster_mask(
        xp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        yp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(xp), nx, ny, dx0, dx1, dy0, dy1,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return mask
