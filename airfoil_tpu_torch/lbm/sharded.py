"""Spatially decomposed LBM over a mesh of ranks: port of
``airfoil_tpu/lbm/sharded.py``.

The lattice is split along rows (y) over the ranks of a ``Mesh``
(``parallel.mesh``). Each round exchanges an h-row halo with the two
neighbours on the ring, advances the extended block h steps and crops the
h rows again: staleness grows inward one row a step from the block's edges,
so the rows kept are exact, and the ranks exchange once every h steps
instead of every step. The boundary masks are the global lattice's,
extended with the block: the global top and bottom rows stay pinned by the
edge equilibrium however the rows are split.

On a card each round runs the port's hand kernels on the extended block:
``lbm.kernel.lbm_steps`` where it holds the block, else
``lbm_steps_tiled`` (``prefers_tiled``), each with the block's rows of the
global cell word. On the CPU, where those wrappers take the plain step and
derive the masks from the block's own shape, a round calls
``core.step_body`` with the extended global masks, as the reference's body
does.
"""

from __future__ import annotations

import torch

from airfoil_tpu_torch.lbm import core, kernel
from airfoil_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                             neighbour_exchange)

__all__ = ["dryrun_sharded_step", "extended_rows", "gather_rows",
           "sharded_lbm_steps"]


def extended_rows(a: torch.Tensor, r0: int, r1: int, k: int) -> torch.Tensor:
    """Rows [r0 - k, r1 + k) of the (NY, NX) ``a``, modulo NY. A uint16
    cell word is indexed through its int16 view."""
    idx = torch.arange(r0 - k, r1 + k, device=a.device) % a.shape[0]
    if a.dtype == torch.uint16:
        return a.view(torch.int16).index_select(0, idx).view(torch.uint16)
    return a.index_select(0, idx)


def _card_rounds(solid, r0, r1, u0, tau):
    """The rounds on a card: ``build(k)`` is a round's k steps by the
    resident kernel where it holds the extended block, else the tiled one,
    with the extended global word (one ``cell_word`` launch a call).

    The word's outlet and edge bits (9, 10) are the global lattice's, as
    they must be: ``cell_word`` of the extended mask would mark the
    extended block's own first and last rows as edges, and not the global
    row 0 or NY - 1 inside it. Its bounce bits differ from those of the
    extended mask (the reference's ``bounce_masks(solid_ext)``) only in the
    outermost halo rows, whose streaming sources lie outside the block;
    those rows are stale after the first step anyway, and staleness moves
    one row a step, so the rows a round keeps never see the difference."""
    word = kernel.cell_word(solid)
    limits = kernel.device_limits(solid.device)

    def build(k):
        solid_ext = extended_rows(solid, r0, r1, k)
        word_ext = extended_rows(word, r0, r1, k)
        step = (kernel.lbm_steps_tiled
                if kernel.prefers_tiled(*solid_ext.shape, *limits)
                else kernel.lbm_steps)

        def advance(f_ext):
            return step(f_ext, solid_ext, u0, tau, k, word=word_ext)
        return advance
    return build


def _plain_rounds(solid, r0, r1, u0, tau):
    """The rounds of the plain step: ``build(k)`` is a round's k steps of
    ``core.step_body`` with the extended global masks (the reference's
    round body)."""
    masks = core.boundary_masks(solid.shape[0], solid.shape[1], solid.device)

    def build(k):
        solid_ext = extended_rows(solid, r0, r1, k)
        outlet_ext, edge_ext = (extended_rows(m, r0, r1, k) for m in masks)
        bounce_ext = core.bounce_masks(solid_ext)

        def advance(f_ext):
            for _ in range(k):
                f_ext = core.step_body(f_ext, solid_ext, u0, tau,
                                       masks=(outlet_ext, edge_ext),
                                       bounce=bounce_ext)
            return f_ext
        return advance
    return build


def sharded_lbm_steps(mesh: Mesh, f, solid, u0, tau, steps: int,
                      halo_steps: int = 8) -> torch.Tensor:
    """Advance ``steps`` LBM steps with rows split over the mesh's ranks.

    ``f``: the whole (9, NY, NX) lattice and ``solid`` its (NY, NX) mask,
    the same on every rank, NY divisible by the mesh's size. Returns this
    rank's (9, NY / size, NX) rows, advanced, on its device: still sharded
    (``gather_rows`` assembles the lattice). Rounds of h = max(1,
    min(``halo_steps``, steps, NY / size)) steps, and one of the remainder.
    """
    n_dev = mesh.size
    ny, nx = f.shape[1], f.shape[2]
    assert ny % n_dev == 0, f"NY={ny} not divisible by {n_dev} devices"
    rows = ny // n_dev
    h = max(1, min(halo_steps, steps, rows))
    n_full = steps // h
    rem = steps % h
    r0, r1 = mesh.rank * rows, (mesh.rank + 1) * rows
    dev = mesh.device
    f_loc = f[:, r0:r1].to(dev).contiguous()
    solid = torch.as_tensor(solid, dtype=torch.float32,
                            device=dev).contiguous()
    build = (_card_rounds if dev.type == "cuda" else _plain_rounds)(
        solid, r0, r1, u0, tau)
    rounds = {k: build(k) for k in {h, rem} if k}

    def round_of(k, f_loc):
        """Exchange k-row halos, k steps on the extended block, crop."""
        from_below, from_above = neighbour_exchange(
            mesh, f_loc[:, -k:], f_loc[:, :k])
        f_ext = torch.cat([from_below, f_loc, from_above], dim=1)
        return rounds[k](f_ext)[:, k:-k]

    for _ in range(n_full):
        f_loc = round_of(h, f_loc)
    if rem:
        f_loc = round_of(rem, f_loc)
    return f_loc.contiguous()


def gather_rows(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """The whole (9, NY, NX) lattice from every rank's (9, NY / size, NX)
    rows, on every rank's device."""
    parts = all_gather(mesh, block)                   # (size, 9, rows, NX)
    full = parts.permute(1, 0, 2, 3).reshape(
        block.shape[0], -1, block.shape[2])
    return full.to(block.device)


def dryrun_sharded_step(mesh: Mesh) -> None:
    """Tiny-shape smoke run of the row-sharded step on the mesh."""
    from airfoil_tpu_torch.config import LBMConfig
    from airfoil_tpu_torch.lbm.masks import rasterize_airfoil
    from airfoil_tpu_torch.models import naca4

    n_dev = mesh.size
    ny = max(8 * n_dev, 32)
    nx = 64
    cfg = LBMConfig(nx=nx, ny=ny)
    f = core.equilibrium_init(ny, nx, cfg.u0, mesh.device)
    solid = torch.as_tensor(rasterize_airfoil(naca4(0, 0, 12, 30), 4.0, cfg),
                            device=mesh.device)
    out = sharded_lbm_steps(mesh, f, solid, cfg.u0, cfg.tau, steps=4)
    assert bool(torch.isfinite(out).all()), "sharded LBM produced non-finite"
