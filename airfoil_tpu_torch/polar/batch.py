"""Batched multi-airfoil analysis: port of ``airfoil_tpu/polar/batch.py``.

The geometry axis is a lane axis: every airfoil repanels to the same node
count, gets its own inviscid operator, and all of them solve at one
(alpha, Re) as the lanes of one ``solve_polar_points`` call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.inviscid.programs import operator_program
from airfoil_tpu_torch.viscous.newton import solve_polar_points

__all__ = ["BatchResult", "solve_batch"]


class BatchResult(NamedTuple):
    """Per-airfoil arrays, shape (B,)."""

    cl: torch.Tensor
    cd: torch.Tensor
    cdp: torch.Tensor
    cm: torch.Tensor
    converged: torch.Tensor
    xtr_upper: torch.Tensor
    xtr_lower: torch.Tensor
    sep_fraction: torch.Tensor


def _batch_ops(coords_list, n_panels: int, dev) -> list:
    """One inviscid operator a loop on ``dev``; ragged loops are first
    resampled on the host to the first loop's point count, as the
    reference does, then each repanels to ``n_panels``. Each loop is
    built alone (the program ``"operator"`` at one loop's key): lanes
    accumulate their arc length otherwise than one loop does
    (``paneling.panel._arc_length``)."""
    fixed = []
    for c in coords_list:
        c = np.asarray(c, np.float32)
        if len(fixed) and c.shape[0] != fixed[0].shape[0]:
            n = fixed[0].shape[0]
            t = np.linspace(0.0, 1.0, c.shape[0])
            tq = np.linspace(0.0, 1.0, n)
            c = np.stack([np.interp(tq, t, c[:, 0]),
                          np.interp(tq, t, c[:, 1])], axis=1)
        fixed.append(c)
    coords_b = torch.as_tensor(np.stack(fixed).astype(np.float32),
                               device=dev)
    return [operator_program(c, n_panels)[0] for c in coords_b]


def solve_batch(coords_list, reynolds: float, alpha: float,
                n_panels: int = 160, device=None) -> BatchResult:
    """Analyze a batch of airfoils at one (alpha, Re) on ``device`` (see
    ``resolve_device``), one lane an airfoil.

    ``coords_list``: sequence of (M_i, 2) loops (ragged OK; see
    ``_batch_ops``).
    """
    ops = _batch_ops(coords_list, n_panels, resolve_device(device))
    out, _extra = solve_polar_points(ops, float(alpha), float(reynolds),
                                     n_stations=96)
    return BatchResult(*out)
