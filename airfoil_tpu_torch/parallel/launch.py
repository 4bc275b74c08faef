"""Start the ranks of a mesh: one process a rank, every one running the same
function (SPMD). JAX's mesh lives in one process and has no counterpart of
this module; a ``torch.distributed`` mesh needs its ranks started.

``run(fn, world_size, *args)`` spawns ``world_size`` processes (the
``spawn`` start method, so a parent that already holds a CUDA context may
call it), joins each to a process group through a file in a temporary
directory, and calls ``fn(mesh, *args)`` in each with its ``Mesh``
(``parallel.mesh.batch_mesh``). It returns rank 0's return value. ``fn``
must be importable by name (a module-level function), and what it returns
must pickle.

- On ``cuda`` the backend is NCCL, and rank r runs on card r: every rank
  has a card of its own. NCCL refuses two ranks on one card, so ranks that
  share one run only when the caller asks for ``backend="gloo"`` (rank r
  on card r modulo the card count); their exchanges then go through host
  memory. ``backend="nccl"`` with more ranks than cards raises before any
  process starts.
- On the CPU the backend is gloo.
- A rank that fails fails the call with its traceback (the other ranks are
  stopped); nothing carries on with fewer ranks or on another device.
"""

from __future__ import annotations

import glob
import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.parallel.mesh import batch_mesh

__all__ = ["run"]

_RESULT = "rank0.pkl"


def _rank_main(rank: int, world_size: int, fn, args, dev_type: str,
               backend: str, tmp: str) -> None:
    if dev_type == "cuda":
        index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    else:
        device = torch.device("cpu")
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=world_size)
    try:
        try:
            out = fn(batch_mesh(device), *args)
        except BaseException:
            # The first rank to fail is the one to report: the others may
            # fail after it, as their exchanges with it break.
            with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
                fh.write(traceback.format_exc())
            raise
        if rank == 0:
            path = os.path.join(tmp, _RESULT)
            with open(path + ".part", "wb") as fh:
                pickle.dump(out, fh)
            os.replace(path + ".part", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _report(paths) -> str:
    """The failed ranks' tracebacks, the first to fail first."""
    out = []
    for i, path in enumerate(paths):
        name = os.path.basename(path)[:-len(".err")]
        with open(path) as fh:
            out.append(f"-- {name} failed{' first' if i == 0 else ''}:\n"
                       f"{fh.read()}")
    return "\n".join(out)


def run(fn, world_size: int, *args, device=None, backend: str | None = None):
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks and return rank 0's
    return value (see the module docstring). ``device`` is resolved by
    ``resolve_device`` (``cuda`` unless the caller asks for the CPU);
    ``backend`` is ``"nccl"`` (the default on ``cuda``) or ``"gloo"`` (the
    CPU's, and ranks that share a card)."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"nccl runs on cuda, not {dev}")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl needs a card a rank: {world_size} ranks, {cards} "
                f"card(s); pass backend='gloo' for ranks that share a card")
    with tempfile.TemporaryDirectory(prefix="airfoil_tpu_torch_ranks_") as tmp:
        try:
            mp.spawn(_rank_main, args=(world_size, fn, args, dev.type,
                                       backend, tmp),
                     nprocs=world_size, join=True, start_method="spawn")
        except ProcessException as exc:
            errs = sorted(glob.glob(os.path.join(tmp, "rank*.err")),
                          key=os.path.getmtime)
            raise RuntimeError(_report(errs) or str(exc)) from exc
        with open(os.path.join(tmp, _RESULT), "rb") as fh:
            return pickle.load(fh)
