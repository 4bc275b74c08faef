"""The two D2Q9 step kernels and the cell word, each by its CUDA kernel on a
CUDA tensor.

- ``lbm_steps``: counterpart of ``airfoil_tpu/lbm/kernel.py::
  lbm_steps_pallas``; launches ``csrc/lbm_steps.cu``, which keeps the whole
  lattice on chip for a whole call: one cooperative launch of one block per
  SM, each owning a tile (``resident_plan``), exchanging tile edges through
  L2 between steps. It holds lattices up to what the SMs' shared memory
  holds (about 400,000 cells on an H100) and refuses larger ones.
- ``lbm_steps_tiled``: counterpart of ``lbm_steps_pallas_tiled``; launches
  ``csrc/lbm_steps_tiled.cu``, K steps per launch on 2-D tiles with a
  K-cell halo, by persistent blocks that TMA-load the next tile's window
  while they step the current one. Any grid.
- ``cell_word``: the (NY, NX) uint16 static word both kernels read per cell
  (bounce bits, outlet, edge equilibrium; ``core.cell_word``), built by one
  launch. It depends on the mask alone, so callers build it once per mask
  and pass it as ``word=``; without it a call builds it first.

Both kernels share their per-cell arithmetic (``csrc/lbm_cell.cuh``), so on
the same input they give the same bits. Each is built at first use (see
``cuda_build``) and raises if the build or a launch fails; on a CPU tensor
each runs the plain torch version (``core.lbm_step``, ``core.cell_word``).
Unlike the Pallas kernels neither has an alignment rule: any (9, NY, NX)
grid and any ``steps >= 1`` is served. ``prefers_tiled`` is the rule that
picks one: the tiled kernel exactly where ``lbm_steps`` cannot hold the
lattice.

``launches``, ``tiled_launches`` and ``word_launches`` count the calls that
went to each CUDA kernel (``cuda_build.launch``); the CPU path never
touches them. Read them as ``kernel.launches`` etc. on the module.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from airfoil_tpu_torch import cuda_build
from airfoil_tpu_torch.cuda_build import device_index
from airfoil_tpu_torch.lbm import core
from airfoil_tpu_torch.lbm.core import edge_equilibrium, inverse_tau, lbm_step

__all__ = ["ResidentPlan", "cell_word", "device_limits", "lbm_steps",
           "lbm_steps_tiled", "load", "load_tiled", "prefers_tiled",
           "resident_plan", "tiled_shape"]

launches = 0
tiled_launches = 0
word_launches = 0

# csrc/lbm_steps.cu's kResidentThreads and kCellsPerThread: threads of a
# resident block, and cells each steps (its launch refuses a larger tile).
RESIDENT_THREADS = 1024
CELLS_PER_THREAD = 4


@dataclass(frozen=True)
class ResidentPlan:
    """``lbm_steps``'s cut of a lattice: ``tiles_x`` x ``tiles_y`` blocks,
    one per SM, of ``tile_w`` x ``tile_h`` cells (the last of a row or
    column may be ragged)."""

    tiles_x: int
    tiles_y: int
    tile_w: int
    tile_h: int

    @property
    def blocks(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def smem_bytes(self) -> int:
        """Two window buffers (tile and one-cell ring) of 9 floats a cell."""
        return resident_smem(self.tile_w, self.tile_h)

    @property
    def exchange_floats(self) -> int:
        """Two surfaces (by step parity) of every block's edge record."""
        return 2 * self.blocks * 9 * 2 * (self.tile_w + self.tile_h)

    def tiles(self, ny: int, nx: int):
        """(y0, x0, h, w) of every block's tile, in block order."""
        return [(ty * self.tile_h, tx * self.tile_w,
                 min(self.tile_h, ny - ty * self.tile_h),
                 min(self.tile_w, nx - tx * self.tile_w))
                for ty in range(self.tiles_y) for tx in range(self.tiles_x)]


def resident_smem(tile_w: int, tile_h: int) -> int:
    return 2 * 9 * (tile_w + 2) * (tile_h + 2) * 4


def resident_plan(ny: int, nx: int, sm_count: int,
                  smem_per_block: int) -> ResidentPlan | None:
    """The tiling that ``lbm_steps`` runs an (NY, NX) lattice with on a card
    of ``sm_count`` SMs and ``smem_per_block`` bytes of opt-in shared memory
    a block: at most one block per SM, each tile's two windows in its
    block's shared memory, the smallest window (so the least work and
    exchange for the slowest block) and then the fewest blocks. ``None``
    when no tiling fits: the lattice is past the kernel's capacity."""
    best = None
    for tx_want in range(1, min(nx, sm_count) + 1):
        tw = -(-nx // tx_want)
        tiles_x = -(-nx // tw)
        ty_want = min(ny, sm_count // tiles_x)
        th = -(-ny // ty_want)
        tiles_y = -(-ny // th)
        if (tw * th > RESIDENT_THREADS * CELLS_PER_THREAD
                or resident_smem(tw, th) > smem_per_block):
            continue
        key = ((tw + 2) * (th + 2), tiles_x * tiles_y)
        if best is None or key < best[0]:
            best = (key, ResidentPlan(tiles_x, tiles_y, tw, th))
    return None if best is None else best[1]


def prefers_tiled(ny: int, nx: int, sm_count: int,
                  smem_per_block: int) -> bool:
    """True exactly when ``lbm_steps`` cannot hold an (NY, NX) lattice on
    such a card (``device_limits``): the card's counterpart of the JAX
    runner's VMEM rule."""
    return resident_plan(ny, nx, sm_count, smem_per_block) is None


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and bind the resident kernel's library (which also
    holds the cell-word kernel)."""
    lib = cuda_build.load_library("lbm_steps")
    return cuda_build.bind(lib, "lbm_error_string", {
        "lbm_steps_launch":
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I, _P],
        "lbm_cell_word_launch": [_P, _P, _I, _I, _I, _P],
        "lbm_device_limits": [_I, ctypes.POINTER(ctypes.c_int)]})


@functools.cache
def load_tiled() -> ctypes.CDLL:
    """Build (if needed) and bind the K-steps-per-launch kernel's library."""
    lib = cuda_build.load_library("lbm_steps_tiled")
    return cuda_build.bind(lib, "lbm_error_string", {
        "lbm_steps_tiled_launch":
            [_P, _P, _P, _P, _I, _I, _I, _P, _F, _I, _P],
        "lbm_tiled_shape": [_I, ctypes.POINTER(ctypes.c_int)]})


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> tuple[int, int]:
    lib = load()
    out = (ctypes.c_int * 2)()
    cuda_build.check(lib, "lbm_device_limits",
                     lib.lbm_device_limits(index, out))
    return out[0], out[1]


def device_limits(device) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block in bytes) of a CUDA
    device, the two numbers ``resident_plan`` and ``prefers_tiled`` take."""
    return _limits(device_index(device))


@functools.lru_cache(maxsize=None)
def _tiled_shape(index: int) -> dict:
    lib = load_tiled()
    shape = (ctypes.c_int * 7)()
    cuda_build.check(lib, "lbm_tiled_shape",
                     lib.lbm_tiled_shape(index, shape))
    return dict(zip(("tile_x", "tile_y", "steps", "smem_bytes", "threads",
                     "blocks_per_sm", "sm_count"), shape))


def tiled_shape(device="cuda") -> dict:
    """The tiled kernel as compiled and as it runs on ``device``: tile width
    and height, steps per launch (the halo width), dynamic shared memory and
    threads per block, blocks per SM and the SM count."""
    return dict(_tiled_shape(device_index(device)))


@functools.lru_cache(maxsize=None)
def _plan_on(index: int, ny: int, nx: int) -> ResidentPlan | None:
    return resident_plan(ny, nx, *_limits(index))


@functools.lru_cache(maxsize=64)
def _params(u0: float, tau: float):
    """(the 9 edge-equilibrium floats as a C array, 1/tau): read, never
    written, by the launch functions."""
    return (ctypes.c_float * 9)(*edge_equilibrium(u0)), inverse_tau(tau)


def _check(f, solid, steps, word):
    if not isinstance(f, torch.Tensor) or f.dtype != torch.float32:
        raise TypeError(f"f must be a float32 tensor, got "
                        f"{getattr(f, 'dtype', type(f))}")
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"f must be (9, NY, NX), got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")
    _check_mask(solid, "solid", torch.float32, f.shape[1:], f.device)
    if word is not None:
        _check_mask(word, "word", torch.uint16, f.shape[1:], f.device)
    if int(steps) != steps or steps < 1:
        raise ValueError(f"steps must be a positive integer, got {steps}")
    if f.numel() >= 2 ** 31:
        raise ValueError("lattice too large for 32-bit indexing")


def _check_mask(a, name, dtype, shape, device):
    if not isinstance(a, torch.Tensor) or a.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor, got "
                        f"{getattr(a, 'dtype', type(a))}")
    if tuple(a.shape) != tuple(shape) or not a.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(a.shape)}")
    if a.device != device:
        raise ValueError(f"{name} on {a.device}, f on {device}")


def cell_word(solid: torch.Tensor) -> torch.Tensor:
    """The (NY, NX) uint16 static cell word of a (NY, NX) float32 mask
    (``core.cell_word``), by one launch of ``cell_word_kernel`` on a CUDA
    tensor."""
    if solid.dim() != 2:
        raise ValueError(f"solid must be (NY, NX), got {tuple(solid.shape)}")
    _check_mask(solid, "solid", torch.float32, solid.shape, solid.device)
    if solid.device.type == "cpu":
        return core.cell_word(solid)
    ny, nx = solid.shape
    word = torch.empty((ny, nx), dtype=torch.uint16, device=solid.device)
    cuda_build.launch(load(), "lbm_cell_word_launch",
                      [solid.data_ptr(), word.data_ptr(), ny, nx],
                      solid.device, (__name__, "word_launches"))
    return word


def lbm_steps(f: torch.Tensor, solid: torch.Tensor, u0: float, tau: float,
              steps: int = 4, word: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Advance ``steps`` LBM steps in one launch; returns a new (9, NY, NX)
    tensor (a view at the head of the call's one allocation, which also
    holds the exchange surfaces). ``word`` is ``cell_word(solid)``, built
    here when absent. Raises ``ValueError`` before any launch when the
    lattice is past the card's capacity (``prefers_tiled``)."""
    _check(f, solid, steps, word)
    if f.device.type == "cpu":
        return lbm_step(f, solid, u0, tau, steps=int(steps))
    index = device_index(f.device)
    ny, nx = f.shape[1], f.shape[2]
    plan = _plan_on(index, ny, nx)
    if plan is None:
        sm_count, smem = _limits(index)
        raise ValueError(
            f"lbm_steps cannot hold a {ny}x{nx} lattice on chip ({sm_count} "
            f"SMs x {smem} B of shared memory); use lbm_steps_tiled")
    if word is None:
        word = cell_word(solid)
    n = f.numel()
    # One allocation and one view: each further torch op here costs the
    # served call as much host time as the launch itself.
    out = torch.empty(n + plan.exchange_floats, dtype=f.dtype,
                      device=f.device).as_strided(f.shape, f.stride())
    feq, inv_tau = _params(float(u0), float(tau))
    head = out.data_ptr()
    cuda_build.launch(load(), "lbm_steps_launch", [
        f.data_ptr(), head, head + 4 * n, word.data_ptr(), ny, nx,
        int(steps), plan.tiles_x, plan.tiles_y, plan.tile_w, plan.tile_h,
        feq, inv_tau], f.device, (__name__, "launches"))
    return out


def lbm_steps_tiled(f: torch.Tensor, solid: torch.Tensor, u0: float,
                    tau: float, steps: int = 4,
                    word: torch.Tensor | None = None) -> torch.Tensor:
    """Advance ``steps`` LBM steps, K per launch in shared memory; returns a
    new (9, NY, NX) tensor equal to ``lbm_steps``'s. ``word`` is
    ``cell_word(solid)``, built here when absent."""
    _check(f, solid, steps, word)
    if f.device.type == "cpu":
        return lbm_step(f, solid, u0, tau, steps=int(steps))
    index = device_index(f.device)
    if word is None:
        word = cell_word(solid)
    out = torch.empty_like(f)
    scratch = (torch.empty_like(f) if steps > _tiled_shape(index)["steps"]
               else None)
    feq, inv_tau = _params(float(u0), float(tau))
    cuda_build.launch(load_tiled(), "lbm_steps_tiled_launch", [
        f.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        word.data_ptr(), f.shape[1], f.shape[2], int(steps), feq, inv_tau],
        f.device, (__name__, "tiled_launches"))
    return out
