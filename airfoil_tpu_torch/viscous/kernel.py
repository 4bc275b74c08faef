"""The boundary-layer march, by its CUDA kernel on a CUDA tensor.

Counterparts of ``airfoil_tpu/viscous/march.py::march_side`` and
``march_wake`` (``lax.scan`` bodies, no Pallas kernel): on a CUDA tensor
each call is one launch of ``csrc/bl_march.cu`` (one block per lane, of
two warps that evaluate the Newton Jacobian's rows side by side, three
threads of each carrying its columns; all stations and Newton iterations
in the launch); on a CPU tensor it runs the plain torch march,
``viscous.march``. The library is built at first use (see ``cuda_build``)
and a failed build or launch raises; there is no fallback.

``march_launches`` counts the ``march_side`` calls that went to the CUDA
kernel (``march_side_kernel``), ``wake_launches`` the ``march_wake`` ones
(``march_wake_kernel``); the CPU path touches neither. Read them on the
module (``kernel.march_launches``). A launch captured into a CUDA graph
(``viscous.graphs``) is tallied, not counted (``tallied``), and counted at
each replay of the graph (``add_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from airfoil_tpu_torch.cuda_build import load_library
from airfoil_tpu_torch.device import DTYPE
from airfoil_tpu_torch.viscous import march as plain
from airfoil_tpu_torch.viscous.march import BLState, _as_lanes, _lanes

__all__ = ["load", "march_side", "march_wake"]

march_launches = 0
wake_launches = 0
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()     # this thread's tally while it captures
# Rounding as torch's one-operation-per-kernel arithmetic: no contraction
# of multiply-adds into FMAs.
_FLAGS = ("-fmad=false",)


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the march kernel's library."""
    lib = load_library("bl_march", ["bl_march.cu"], _FLAGS)
    if lib.bl_march_side_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bl_march_side_launch.argtypes = [ptr] * 15 + [i32, i32, i32, ptr]
        lib.bl_march_side_launch.restype = i32
        lib.bl_march_wake_launch.argtypes = [ptr] * 9 + [i32, i32, i32, ptr]
        lib.bl_march_wake_launch.restype = i32
        lib.bl_error_string.argtypes = [i32]
        lib.bl_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, arrays: dict, shape) -> None:
    for key, a in arrays.items():
        if not isinstance(a, torch.Tensor) or a.dtype != DTYPE:
            raise TypeError(f"{name}: {key} must be a float32 tensor, got "
                            f"{getattr(a, 'dtype', type(a))}")
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(a.shape)}, "
                             f"want {tuple(shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    devices = {a.device for a in arrays.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    if shape[1] < 1:
        raise ValueError(f"{name}: needs at least one station")


def _launch(lib, fn: str, args, device: torch.device, counter: str) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: "
                           f"{lib.bl_error_string(err).decode()}")
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[counter] = tally.get(counter, 0) + 1
        return
    with _COUNT_LOCK:
        globals()[counter] += 1


@contextlib.contextmanager
def tallied():
    """Inside, this thread's launches go to the dict it yields ({counter
    name: launches}) instead of the counters: a graph's capture, whose
    launches run at its replays."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = {}
    try:
        yield _TALLY.counts
    finally:
        _TALLY.counts = outer


def add_launches(tally: dict, times: int = 1) -> None:
    """Count ``times`` the launches of ``tally`` (a replayed graph's)."""
    with _COUNT_LOCK:
        for counter, n in tally.items():
            globals()[counter] += n * times


def march_side(s, ue, x, nu, n_crit=9.0, x_forced_transition=1.0
               ) -> BLState:
    """``march.march_side``: (L, M) or (M,) stations, per-lane or scalar
    ``nu``, ``n_crit`` and ``x_forced_transition``."""
    one, (s2, ue2, x2) = _as_lanes(s, ue, x)
    _check("march_side", {"s": s2, "ue": ue2, "x": x2}, s2.shape)
    dev = s2.device
    if dev.type == "cpu":
        return plain.march_side(s, ue, x, nu, n_crit, x_forced_transition)
    if dev.type != "cuda":
        raise ValueError(f"march_side runs on cpu or cuda, not {dev}")
    lanes, m = s2.shape
    params = [_lanes(p, s2) for p in (nu, n_crit, x_forced_transition)]
    floats = [torch.empty_like(s2) for _ in range(6)]
    flags = [torch.empty((lanes, m), dtype=torch.bool, device=dev)
             for _ in range(2)]
    x_tr = torch.empty(lanes, dtype=DTYPE, device=dev)
    ptrs = [a.data_ptr() for a in (s2, ue2, x2, *params, *floats, *flags,
                                   x_tr)]
    _launch(load(), "bl_march_side_launch", ptrs + [lanes, m], dev,
            "march_launches")
    bl = BLState(*floats, *flags, x_transition=x_tr)
    if one:
        bl = BLState(*(a[0] for a in bl))
    return bl


def march_wake(s, ue, nu, theta0, dstar0, ctau0):
    """``march.march_wake``: (L, Mw) or (Mw,) stations, per-lane or scalar
    states; returns (theta, dstar, hk)."""
    one, (s2, ue2) = _as_lanes(s, ue)
    _check("march_wake", {"s": s2, "ue": ue2}, s2.shape)
    dev = s2.device
    if dev.type == "cpu":
        return plain.march_wake(s, ue, nu, theta0, dstar0, ctau0)
    if dev.type != "cuda":
        raise ValueError(f"march_wake runs on cpu or cuda, not {dev}")
    lanes, m = s2.shape
    params = [_lanes(p, s2) for p in (nu, theta0, dstar0, ctau0)]
    outs = [torch.empty_like(s2) for _ in range(3)]
    ptrs = [a.data_ptr() for a in (s2, ue2, *params, *outs)]
    _launch(load(), "bl_march_wake_launch", ptrs + [lanes, m], dev,
            "wake_launches")
    if one:
        outs = [a[0] for a in outs]
    return tuple(outs)
