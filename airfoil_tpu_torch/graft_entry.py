"""Entry points of the port beside the reference's ``__graft_entry__.py``:
one forward solve of the flagship model, and a multi-rank dry run.

- ``entry(device=None)`` returns ``(fn, example_args)``: ``fn(coords,
  alpha, reynolds)`` is a plain torch callable, one coupled viscous airfoil
  solve (repanel to 128 panels, panel operator, boundary-layer march and
  viscous-inviscid coupling at 48 stations, 16 wake stations and 12
  passes) returning ``[cl, cd, cm]``; the arguments are NACA 2412 (60
  points a side) at alpha 5, Re 1e6, on the device.
- ``dryrun_multichip(n_devices, device=None, backend=None)`` starts
  ``n_devices`` ranks (``parallel.launch.run``) that run ``sharded_polar``
  on a tiny polar and then ``dryrun_sharded_step``, and prints one line.

    python -m airfoil_tpu_torch.graft_entry [N]    # on the card(s)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from airfoil_tpu_torch.device import DTYPE, resolve_device

__all__ = ["dryrun_multichip", "entry"]


def entry(device=None):
    """(fn, example_args) of one coupled viscous solve on ``device``
    (``resolve_device``: ``cuda`` unless the caller asks for the CPU)."""
    from airfoil_tpu_torch.inviscid import build_operator
    from airfoil_tpu_torch.models import naca4
    from airfoil_tpu_torch.paneling import panel_geometry, repanel
    from airfoil_tpu_torch.viscous import solve_viscous

    dev = resolve_device(device)

    def fn(coords, alpha, reynolds):
        xp, yp = repanel(coords, 128)
        op = build_operator(panel_geometry(xp, yp))
        res = solve_viscous(op, alpha, reynolds,
                            n_stations=48, n_wake=16, coupling_iters=12)
        return torch.stack([res.cl, res.cd, res.cm])

    coords = torch.as_tensor(np.asarray(naca4(2, 4, 12, 60), np.float32),
                             device=dev)
    example_args = (coords, torch.tensor(5.0, dtype=DTYPE, device=dev),
                    torch.tensor(1e6, dtype=DTYPE, device=dev))
    return fn, example_args


def _dryrun_rank(mesh):
    """One rank of ``dryrun_multichip``: the sharded polar, one point a
    rank, then the sharded LBM step. Returns the polar's CL."""
    from airfoil_tpu_torch.lbm import dryrun_sharded_step
    from airfoil_tpu_torch.models import naca4
    from airfoil_tpu_torch.parallel import sharded_polar

    coords = np.asarray(naca4(2, 4, 12, 40), np.float32)
    alphas = np.linspace(-2.0, 8.0, mesh.size, dtype=np.float32)
    cl, *_rest = sharded_polar(mesh, coords, alphas, 1e6, n_panels=64)
    assert cl.shape == (mesh.size,)
    assert bool(np.all(np.isfinite(cl)))
    dryrun_sharded_step(mesh)
    return cl


def dryrun_multichip(n_devices: int, device=None, backend=None) -> None:
    """Run the sharded polar and the sharded LBM step on ``n_devices``
    ranks (``parallel.launch.run``: NCCL with a card a rank by default on
    ``cuda``, gloo where ``backend="gloo"`` or on the CPU)."""
    from airfoil_tpu_torch.parallel.launch import run

    cl = run(_dryrun_rank, n_devices, device=device, backend=backend)
    print(f"dryrun_multichip OK on {n_devices} devices; "
          f"CL={np.round(np.asarray(cl), 3).tolist()}")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    fn, args = entry()
    print("entry OK:", fn(*args).tolist())
    dryrun_multichip(n)
