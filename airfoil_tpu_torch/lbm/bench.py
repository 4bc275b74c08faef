"""LBM throughput benchmark (MLUPS: million lattice-site updates per second).

Port of ``airfoil_tpu/lbm/bench.py`` with the same grid defaults and steps
per call. ``kernel`` says whether a CUDA kernel or the plain torch step
(``core.lbm_step``) is timed; it defaults to a kernel on a CUDA device and
to the plain step on the CPU, and asking for a kernel on the CPU raises.
``tiled`` says which kernel: ``lbm_steps_tiled`` or ``lbm_steps``; left
``None`` it follows the wind tunnel's rule (``prefers_tiled``: the tiled
kernel where ``lbm_steps`` cannot hold the lattice). The cell word is built
once, before the timed loop, as the wind tunnel builds it once per mask.
The result reports what ran. The loop is timed on the host clock between
two ``utils.profiling.device_sync`` calls (``torch.cuda.synchronize()`` and
a read of one value).
"""

from __future__ import annotations

import time

import torch

from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.lbm.core import equilibrium_init, lbm_step
from airfoil_tpu_torch.lbm.kernel import (cell_word, device_limits,
                                          lbm_steps, lbm_steps_tiled,
                                          prefers_tiled)
from airfoil_tpu_torch.lbm.masks import rasterize_airfoil
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.utils.profiling import device_sync

__all__ = ["bench_mlups"]


def bench_mlups(nx: int = 640, ny: int = 384, steps_per_call: int = 128,
                n_calls: int = 8, device=None,
                kernel: bool | None = None,
                tiled: bool | None = None) -> dict:
    """Time ``n_calls`` calls of ``steps_per_call`` fused steps on the
    NACA 2412 lattice at alpha=6, after one warm-up call (which also
    builds the kernel)."""
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    kernel = on_cuda if kernel is None else kernel
    if kernel and not on_cuda:
        raise ValueError("the CUDA kernels run only on a CUDA device")
    if tiled is None:
        tiled = kernel and prefers_tiled(ny, nx, *device_limits(dev))
    if tiled and not kernel:
        raise ValueError("tiled names a CUDA kernel; the plain step has none")

    cfg = LBMConfig(nx=nx, ny=ny)
    mask = torch.as_tensor(rasterize_airfoil(naca4(2, 4, 12, 50), 6.0, cfg),
                           dtype=DTYPE).to(dev)
    f = equilibrium_init(ny, nx, cfg.u0, dev)
    if kernel:
        word = cell_word(mask)
        kern = lbm_steps_tiled if tiled else lbm_steps

        def step(f, *args, **kwargs):
            return kern(f, *args, word=word, **kwargs)
    else:
        step = lbm_step

    f = step(f, mask, cfg.u0, cfg.tau, steps=steps_per_call)
    device_sync(f)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        f = step(f, mask, cfg.u0, cfg.tau, steps=steps_per_call)
    device_sync(f)
    dt = time.perf_counter() - t0

    site_updates = nx * ny * steps_per_call * n_calls
    return {
        "mlups": site_updates / dt / 1e6,
        "seconds": dt,
        "grid": f"{nx}x{ny}",
        "steps": steps_per_call * n_calls,
        "kernel": bool(kernel),
        "tiled": bool(tiled),
        "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "platform": "gpu" if on_cuda else "cpu",
        "finite": bool(torch.isfinite(f).all()),
    }
