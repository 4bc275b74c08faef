"""The two D2Q9 step kernels, each by its CUDA kernel on a CUDA tensor.

- ``lbm_steps``: counterpart of ``airfoil_tpu/lbm/kernel.py::
  lbm_steps_pallas``; launches ``csrc/lbm_steps.cu``, one launch per step.
  Fast while the lattice's two buffers stay in L2.
- ``lbm_steps_tiled``: counterpart of ``lbm_steps_pallas_tiled``; launches
  ``csrc/lbm_steps_tiled.cu``, which keeps K steps per launch in shared
  memory on 2-D tiles with a K-cell halo. For lattices beyond L2.

Both kernels share their per-cell arithmetic (``csrc/lbm_cell.cuh``), so on
the same input they give the same bits. Each is built at first use (see
``cuda_build``) and raises if the build or a launch fails; on a CPU tensor
each runs the plain torch version, ``core.lbm_step``. Unlike the Pallas
kernels neither has an alignment rule: any (9, NY, NX) grid and any
``steps >= 1`` is served. ``prefers_tiled`` is the rule that picks one.

``launches`` and ``tiled_launches`` count the calls that went to each CUDA
kernel (one call runs the bounce-mask launch and then one launch per step,
or per K steps); the CPU path never touches them. Read them as
``kernel.launches`` and ``kernel.tiled_launches`` on the module.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from airfoil_tpu_torch.cuda_build import load_library
from airfoil_tpu_torch.lbm.core import edge_equilibrium, inverse_tau, lbm_step

__all__ = ["lbm_steps", "lbm_steps_tiled", "load", "load_tiled",
           "prefers_tiled", "tiled_shape"]

launches = 0
tiled_launches = 0
_COUNT_LOCK = threading.Lock()


def _bind(name: str, source: str, launch: str) -> ctypes.CDLL:
    lib = load_library(name, [source])
    fn = getattr(lib, launch)
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ptr, ctypes.c_float, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        lib.lbm_error_string.argtypes = [ctypes.c_int]
        lib.lbm_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the one-step kernel's library."""
    return _bind("lbm_steps", "lbm_steps.cu", "lbm_steps_launch")


def load_tiled() -> ctypes.CDLL:
    """Build (if needed) and bind the K-steps-per-launch kernel's library."""
    lib = _bind("lbm_steps_tiled", "lbm_steps_tiled.cu",
                "lbm_steps_tiled_launch")
    if lib.lbm_tiled_shape.argtypes is None:
        lib.lbm_tiled_shape.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.lbm_tiled_shape.restype = None
    return lib


def tiled_shape() -> dict:
    """The tiled kernel as compiled: tile width and height, steps per
    launch (the halo width) and dynamic shared memory per block."""
    shape = (ctypes.c_int * 4)()
    load_tiled().lbm_tiled_shape(shape)
    return dict(zip(("tile_x", "tile_y", "steps", "smem_bytes"), shape))


def prefers_tiled(ny: int, nx: int, l2_bytes: int) -> bool:
    """True when the two (9, NY, NX) float32 buffers of the one-step kernel
    exceed ``l2_bytes``, so every step would go through device memory: the
    card's counterpart of the JAX runner's 20 MB VMEM rule."""
    return 2 * 9 * ny * nx * 4 > l2_bytes


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


def _launch(lib, launch: str, f, solid, u0, tau, steps, name: str):
    ny, nx = f.shape[1], f.shape[2]
    out = torch.empty_like(f)
    scratch = torch.empty_like(f) if steps > 1 else None
    bits = torch.empty((ny, nx), dtype=torch.int16, device=f.device)
    feq_in = (ctypes.c_float * 9)(*edge_equilibrium(u0))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = getattr(lib, launch)(
        f.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        solid.data_ptr(), bits.data_ptr(), ny, nx, int(steps), feq_in,
        inverse_tau(tau), f.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.lbm_error_string(err).decode()}")
    return out


def lbm_steps(f: torch.Tensor, solid: torch.Tensor, u0: float, tau: float,
              steps: int = 4) -> torch.Tensor:
    """Advance ``steps`` LBM steps; returns a new (9, NY, NX) tensor."""
    global launches
    _check(f, solid, steps)
    if f.device.type == "cpu":
        return lbm_step(f, solid, u0, tau, steps=int(steps))
    if f.device.type != "cuda":
        raise ValueError(f"lbm_steps runs on cpu or cuda, not {f.device}")
    out = _launch(load(), "lbm_steps_launch", f, solid, u0, tau, steps,
                  "lbm_steps")
    with _COUNT_LOCK:
        launches += 1
    return out


def lbm_steps_tiled(f: torch.Tensor, solid: torch.Tensor, u0: float,
                    tau: float, steps: int = 4) -> torch.Tensor:
    """Advance ``steps`` LBM steps, K per launch in shared memory; returns a
    new (9, NY, NX) tensor equal to ``lbm_steps``'s."""
    global tiled_launches
    _check(f, solid, steps)
    if f.device.type == "cpu":
        return lbm_step(f, solid, u0, tau, steps=int(steps))
    if f.device.type != "cuda":
        raise ValueError(f"lbm_steps_tiled runs on cpu or cuda, not "
                         f"{f.device}")
    out = _launch(load_tiled(), "lbm_steps_tiled_launch", f, solid, u0, tau,
                  steps, "lbm_steps_tiled")
    with _COUNT_LOCK:
        tiled_launches += 1
    return out
