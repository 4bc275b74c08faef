"""Rank functions and scripted solver stages for the tests of
``airfoil_tpu_torch.parallel`` and ``airfoil_tpu_torch.lbm.sharded``.

A rank started by ``parallel.launch.run`` imports its function's module,
so the functions live here, in a module that imports no JAX: the spawned
processes stay free of the reference (``tests/test_torch_isolation.py``).
The scripted stages are written once for both packages: each takes the
array module it runs on (``torch`` or ``jax.numpy``) or works on either's
arrays, and forms every output with one rounding from the alphas (an add
then a multiply), so both packages give the same bits.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

N3 = 8      # scripted state width


def points_script(a, xp):
    """A scripted per-point pass over the lanes ``a``: (m1, ok, st1),
    unconverged where round(alpha) % 3 == 0."""
    ok = xp.round(a) % 3 != 0
    zero = a * 0.0
    m1 = ((a + 2.0) * 0.1, (a + 6.0) * 0.001, zero + 0.002, zero - 0.05, ok,
          (a + 10.0) * 0.04, zero + 0.8, zero + 0.01)
    st1 = (xp.tile(a[:, None], (1, N3)), m1[5], m1[6])
    return m1, ok, st1


def torch_points(op, alphas, reynolds):
    """``parallel.mesh._local_points``, scripted."""
    m1, ok, st1 = points_script(alphas, torch)
    return m1, (ok, st1)


def walk_script(op, a_seq, re_seq, active, seg_start, cli_seq, slack_seq,
                m1_seq, nok1_seq, st1_seq, state_like):
    """The walk, scripted: accept the per-point result below alpha 4 where
    active, shifted by the step's slack and inviscid CL (so the sequences
    matter)."""
    used = nok1_seq & active & (a_seq < 4.0)
    m = ((m1_seq[0] + slack_seq[1]) + cli_seq,) + tuple(m1_seq[1:4]) \
        + (m1_seq[4] & used,) + tuple(m1_seq[5:])
    return m, used


def rescue_script(op_s, a, re_, n_stations=None):
    """The smoothed-geometry solve of the lanes (or one point) ``a``,
    scripted: converged below alpha 12."""
    zero = a * 0.0
    return ((a * 0.09, zero + 0.01, zero + 0.004, zero - 0.04, a < 12.0,
             zero + 0.3, zero + 0.7, zero + 0.02), None)


def script_port_polar():
    """Script the port's sharded polar stages in this process."""
    from airfoil_tpu_torch.parallel import mesh as PM

    PM._local_points = torch_points
    PM._walk = walk_script
    PM.solve_polar_points = rescue_script


def scripted_polar_rank(mesh, coords, alphas, reynolds):
    """``sharded_polar`` with scripted stages."""
    from airfoil_tpu_torch.parallel import sharded_polar

    script_port_polar()
    return sharded_polar(mesh, coords, alphas, reynolds)


def live_polar_rank(mesh, coords, alphas, reynolds, n_panels, n_stations):
    """``sharded_polar`` at a reduced station count, once for each Reynolds
    number of ``reynolds``."""
    from airfoil_tpu_torch.parallel import mesh as PM
    from airfoil_tpu_torch.polar import sweep

    PM._N_STATIONS = sweep._N_STATIONS = n_stations
    return [PM.sharded_polar(mesh, coords, alphas, re, n_panels)
            for re in reynolds]


def lbm_rank(mesh, f, solid, u0, tau, plans):
    """``sharded_lbm_steps`` for each (steps, halo_steps) of ``plans``,
    each result gathered (numpy, every rank's copy the same)."""
    from airfoil_tpu_torch.lbm.sharded import gather_rows, sharded_lbm_steps

    f = torch.as_tensor(f)
    solid = torch.as_tensor(solid)
    out = []
    for steps, halo in plans:
        block = sharded_lbm_steps(mesh, f, solid, u0, tau, steps,
                                  halo_steps=halo)
        out.append(gather_rows(mesh, block).cpu().numpy())
    return out


def word_step(f, solid, u0, tau, steps=4, word=None):
    """The plain step as the CUDA kernels take their input: every mask from
    the cell word (bounce bits 0-8, outlet 9, edge equilibrium 10), none
    from the block's shape. Without a word it builds the block's, as the
    kernels' wrappers do."""
    from airfoil_tpu_torch.lbm import core

    if word is None:
        word = core.cell_word(solid)
    w = word.to(torch.int32)
    bounce = tuple(((w >> i) & 1).bool() for i in range(9))
    masks = (((w >> core.OUTLET_BIT) & 1).bool(),
             ((w >> core.EDGE_BIT) & 1).bool())
    for _ in range(steps):
        f = core.step_body(f, solid, u0, tau, masks=masks, bounce=bounce)
    return f


def card_path_patch(limits):
    """Send this process's sharded LBM on the CPU down the card's path:
    its rounds call ``kernel.lbm_steps``/``lbm_steps_tiled`` (here counted
    ``word_step``s) with the extended global word, on a card of ``limits``
    (SM count, shared memory a block)."""
    from airfoil_tpu_torch.lbm import kernel, sharded

    def counted(counter):
        def step(f, solid, u0, tau, steps=4, word=None):
            setattr(kernel, counter, getattr(kernel, counter) + 1)
            return word_step(f, solid, u0, tau, steps, word)
        return step

    def word(solid):
        kernel.word_launches += 1
        return kernel.core.cell_word(solid)

    kernel.lbm_steps = counted("launches")
    kernel.lbm_steps_tiled = counted("tiled_launches")
    kernel.cell_word = word
    kernel.device_limits = lambda device: limits
    sharded._plain_rounds = sharded._card_rounds


def card_path_rank(mesh, f, solid, u0, tau, plans, cards):
    """``lbm_rank`` down the card's path on each card of ``cards`` ({name:
    limits}): {name: (the gathered lattices, every rank's [launches,
    tiled launches, word launches])}."""
    from airfoil_tpu_torch.lbm import kernel

    out = {}
    for name, limits in cards.items():
        card_path_patch(limits)
        kernel.launches = kernel.tiled_launches = kernel.word_launches = 0
        lattices = lbm_rank(mesh, f, solid, u0, tau, plans)
        counts = [kernel.launches, kernel.tiled_launches,
                  kernel.word_launches]
        out[name] = (lattices, all_objects(mesh, counts))
    return out


def all_objects(mesh, obj) -> list:
    import torch.distributed as dist

    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def mesh_rank(mesh):
    """The rank's mesh fields, gathered."""
    from airfoil_tpu_torch.parallel.mesh import all_gather

    row = torch.tensor([mesh.rank, mesh.size], device=mesh.device)
    return {"backend": mesh.backend, "staged": mesh.staged,
            "device": str(mesh.device),
            "ranks": all_gather(mesh, row).cpu().numpy().tolist()}


def exchange_rank(mesh):
    """Each rank sends (rank, +1) forward and (rank, -1) back; returns what
    every rank received, gathered."""
    from airfoil_tpu_torch.parallel.mesh import all_gather, neighbour_exchange

    fwd = torch.tensor([mesh.rank, 1], device=mesh.device)
    bwd = torch.tensor([mesh.rank, -1], device=mesh.device)
    from_prev, from_next = neighbour_exchange(mesh, fwd, bwd)
    return all_gather(mesh, torch.stack([from_prev, from_next])).numpy()


def dryrun_rank(mesh):
    """``dryrun_sharded_step``; returns the modules of the reference or JAX
    this process has loaded."""
    from airfoil_tpu_torch.lbm import dryrun_sharded_step

    dryrun_sharded_step(mesh)
    return sorted(m for m in sys.modules
                  if m.partition(".")[0] in ("jax", "jaxlib", "airfoil_tpu"))


def failing_rank(mesh):
    """Rank 1 raises; the others wait at a barrier."""
    import torch.distributed as dist

    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return np.zeros(1)
