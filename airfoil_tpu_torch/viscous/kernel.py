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
(``viscous.graphs``) is counted at each replay of the graph
(``cuda_build.launch``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from airfoil_tpu_torch import cuda_build
from airfoil_tpu_torch.device import DTYPE
from airfoil_tpu_torch.viscous import march as plain
from airfoil_tpu_torch.viscous.march import BLState, _as_lanes, _lanes

__all__ = ["SIGNATURES", "load", "march_side", "march_wake"]

march_launches = 0
wake_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# bl_march.cu's C interface: bound to this checkout's library by ``load``
# and to an older build of the same source by ``march_compare.py``.
SIGNATURES = {"bl_march_side_launch": [_P] * 15 + [_I, _I, _I, _P],
              "bl_march_wake_launch": [_P] * 9 + [_I, _I, _I, _P]}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and bind the march kernel's library."""
    return cuda_build.bind(cuda_build.load_library("bl_march"),
                           "bl_error_string", SIGNATURES)


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
    cuda_build.launch(load(), "bl_march_side_launch", ptrs + [lanes, m], dev,
                      (__name__, "march_launches"))
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
    cuda_build.launch(load(), "bl_march_wake_launch", ptrs + [lanes, m], dev,
                      (__name__, "wake_launches"))
    if one:
        outs = [a[0] for a in outs]
    return tuple(outs)
