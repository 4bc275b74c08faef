"""``lbm_steps``: K fused D2Q9 steps, by the CUDA kernel on a CUDA tensor.

Counterpart of ``airfoil_tpu/lbm/kernel.py::lbm_steps_pallas``. On a CUDA
tensor it launches ``csrc/lbm_steps.cu`` (built at first use, see
``cuda_build``) and raises if the build or a launch fails; on a CPU tensor
it runs the plain torch version, ``core.lbm_step``. Unlike the Pallas
kernel it has no alignment rule: any (9, NY, NX) grid is served.

``launches`` counts the calls that went to the CUDA kernel (one call runs
the bounce-mask launch and ``steps`` step launches); the CPU path never
touches it. Read it as ``kernel.launches`` on the module.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from airfoil_tpu_torch.cuda_build import load_library
from airfoil_tpu_torch.lbm.core import edge_equilibrium, inverse_tau, lbm_step

__all__ = ["lbm_steps", "load"]

launches = 0
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the kernel library."""
    lib = load_library("lbm_steps", ["lbm_steps.cu"])
    if lib.lbm_steps_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.lbm_steps_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ptr, ctypes.c_float, ctypes.c_int, ptr]
        lib.lbm_steps_launch.restype = ctypes.c_int
        lib.lbm_error_string.argtypes = [ctypes.c_int]
        lib.lbm_error_string.restype = ctypes.c_char_p
    return lib


def _check(f, solid, steps):
    if not isinstance(f, torch.Tensor) or f.dtype != torch.float32:
        raise TypeError(f"f must be a float32 tensor, got "
                        f"{getattr(f, 'dtype', type(f))}")
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"f must be (9, NY, NX), got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")
    if not isinstance(solid, torch.Tensor) or solid.dtype != torch.float32:
        raise TypeError("solid must be a float32 tensor")
    if tuple(solid.shape) != tuple(f.shape[1:]) or not solid.is_contiguous():
        raise ValueError(f"solid must be a contiguous {tuple(f.shape[1:])} "
                         f"tensor, got {tuple(solid.shape)}")
    if solid.device != f.device:
        raise ValueError(f"solid on {solid.device}, f on {f.device}")
    if int(steps) != steps or steps < 1:
        raise ValueError(f"steps must be a positive integer, got {steps}")
    if f.numel() >= 2 ** 31:
        raise ValueError("lattice too large for 32-bit indexing")


def lbm_steps(f: torch.Tensor, solid: torch.Tensor, u0: float, tau: float,
              steps: int = 4) -> torch.Tensor:
    """Advance ``steps`` LBM steps; returns a new (9, NY, NX) tensor."""
    global launches
    _check(f, solid, steps)
    if f.device.type == "cpu":
        return lbm_step(f, solid, u0, tau, steps=int(steps))
    if f.device.type != "cuda":
        raise ValueError(f"lbm_steps runs on cpu or cuda, not {f.device}")

    lib = load()
    ny, nx = f.shape[1], f.shape[2]
    out = torch.empty_like(f)
    scratch = torch.empty_like(f) if steps > 1 else None
    bits = torch.empty((ny, nx), dtype=torch.int16, device=f.device)
    feq_in = (ctypes.c_float * 9)(*edge_equilibrium(u0))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = lib.lbm_steps_launch(
        f.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        solid.data_ptr(), bits.data_ptr(), ny, nx, int(steps), feq_in,
        inverse_tau(tau), f.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"lbm_steps kernel launch failed: "
                           f"{lib.lbm_error_string(err).decode()}")
    with _COUNT_LOCK:
        launches += 1
    return out
