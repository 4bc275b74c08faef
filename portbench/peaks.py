"""The yardstick of the roofline shares: the card's published peaks and the
counts of a kernel's bytes and operations, frozen here so that a change to
the program cannot move them.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores. A
share is stated beside the card's power limit (``card()``).
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# A D2Q9 cell's lattice: 9 float32 populations.
LATTICE_BYTES_PER_CELL = 9 * 4
# The static cell word the LBM kernels read per cell: one uint16.
WORD_BYTES_PER_CELL = 2


def bound_s(moved_bytes: float, ops: float) -> float:
    """The least time the card could take to move ``moved_bytes`` and do
    ``ops`` float32 operations."""
    return max(moved_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def count_ops(fn, *args, **kwargs) -> int:
    """Operations of ``fn`` on its inputs: the elements written by every
    pointwise torch operation it runs, one operation each."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                total += sum(o.numel() for o in tree_leaves(out)
                             if torch.is_tensor(o))
            return out

    with Count():
        fn(*args, **kwargs)
    return total


def lbm_call_bytes(nx: int, ny: int) -> int:
    """Bytes of one multi-step LBM call: the lattice read once and written
    once, and the cell word read once."""
    cells = nx * ny
    return 2 * LATTICE_BYTES_PER_CELL * cells + WORD_BYTES_PER_CELL * cells


def lbm_step_ops(reference, cfg: dict) -> int:
    """Float32 operations of one plain D2Q9 step of the configuration's
    reference tunnel (``Tunnel.step``) on its lattice, on the CPU."""
    from portbench import registry

    naca4 = registry.load_module("airfoils", "naca4").naca4
    tunnel = reference.Tunnel(naca4(0.02, 0.4, 0.12, 100), cfg, 6.0, "cpu",
                              torch.float32)
    return count_ops(tunnel.step)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": torch.cuda.get_device_name(0),
                "power_limit": "not read"}
