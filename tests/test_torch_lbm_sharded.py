"""The port's row-sharded LBM (``airfoil_tpu_torch.lbm.sharded``) and its
launcher against the JAX reference, on the CPU: ranks are gloo processes
started by ``parallel.launch.run``.

- ``sharded_lbm_steps`` at 96x48 over 1, 2 and 4 ranks, 12 steps (one
  round) and 13 steps in rounds of 5 (5, 5, 3), gathered by
  ``gather_rows``: within rtol 2e-5, atol 2e-6 of JAX's
  ``sharded_lbm_steps`` on as many virtual devices and of the port's
  ``lbm_step`` (the bars of ``tests/test_lbm.py``'s sharded tests); the
  one-rank mesh outside any process group gives the same bits;
- the card's path (each round's kernel call, here the plain step reading
  every mask from the cell word as the kernels do, with the extended global
  word) on a card whose resident kernel holds the extended blocks and on
  one where none fits: the plain step's lattice, one launch a round of the
  kernel that holds the block and one word launch a rank and call;
- each rank's extended cell word equals the global word's rows on every
  row a round keeps, and its bounce bits equal those of the extended mask
  everywhere but the outermost halo rows (the global edge rows are why it
  is not the extended mask's own word);
- ``dryrun_sharded_step`` over 2 ranks, and the rows' divisibility check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from airfoil_tpu.lbm.sharded import sharded_lbm_steps as jax_sharded_steps
from airfoil_tpu.parallel import batch_mesh as jax_batch_mesh
from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.lbm import core
from airfoil_tpu_torch.lbm.masks import rasterize_airfoil
from airfoil_tpu_torch.lbm.sharded import (extended_rows, gather_rows,
                                           sharded_lbm_steps)
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.parallel import Mesh, batch_mesh
from airfoil_tpu_torch.parallel import launch

CFG = LBMConfig(nx=96, ny=48)
PLANS = ((12, 8), (13, 5))          # (steps, halo_steps)
RANKS = (1, 2, 4)
RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module")
def lattice():
    """A NACA 2412 mask at alpha 6 and a perturbed freestream, from a
    seed."""
    solid = rasterize_airfoil(naca4(2, 4, 12, 40), 6.0, CFG)
    f0 = core.equilibrium_init(CFG.ny, CFG.nx, CFG.u0, "cpu").numpy()
    rng = np.random.default_rng(10)
    f0 = (f0 * (1.0 + 0.01 * rng.standard_normal(f0.shape))).astype(
        np.float32)
    return f0, solid


@pytest.fixture(scope="module")
def sharded(lattice):
    """{ranks: [the gathered lattice of each plan]} from gloo ranks."""
    f0, solid = lattice
    return {n: launch.run(ranks.lbm_rank, n, f0, solid, CFG.u0, CFG.tau,
                          PLANS, device="cpu") for n in RANKS}


@pytest.mark.parametrize("plan", range(len(PLANS)))
@pytest.mark.parametrize("n", RANKS)
def test_sharded_equals_jax_sharded(sharded, lattice, n, plan):
    f0, solid = lattice
    steps, halo = PLANS[plan]
    mesh = jax_batch_mesh(jax.devices()[:n])
    want = jax_sharded_steps(mesh, jnp.asarray(f0), jnp.asarray(solid),
                             CFG.u0, CFG.tau, steps=steps, halo_steps=halo)
    got = sharded[n][plan]
    assert got.shape == (9, CFG.ny, CFG.nx)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("plan", range(len(PLANS)))
@pytest.mark.parametrize("n", RANKS)
def test_sharded_equals_lbm_step(sharded, lattice, n, plan):
    f0, solid = lattice
    steps, _halo = PLANS[plan]
    want = core.lbm_step(torch.as_tensor(f0), torch.as_tensor(solid),
                         CFG.u0, CFG.tau, steps=steps)
    np.testing.assert_allclose(sharded[n][plan], want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_one_rank_mesh_outside_a_group(sharded, lattice, plan):
    """The one-rank mesh of ``batch_mesh`` outside any process group: the
    exchange is the block's own other end, as in a one-rank group."""
    f0, solid = lattice
    steps, halo = PLANS[plan]
    mesh = batch_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend, mesh.staged) == (0, 1, None,
                                                                 False)
    block = sharded_lbm_steps(mesh, torch.as_tensor(f0),
                              torch.as_tensor(solid), CFG.u0, CFG.tau, steps,
                              halo_steps=halo)
    np.testing.assert_array_equal(gather_rows(mesh, block).numpy(),
                                  sharded[1][plan])


# (SM count, shared memory a block) of a card whose resident kernel holds
# every extended block here, and of one where none fits.
LIMITS = {"resident": (132, 232448), "tiled": (1, 20000)}


@pytest.fixture(scope="module")
def card_path(lattice):
    """{ranks: {card: (lattices, launches a rank)}} down the card's path."""
    f0, solid = lattice
    return {n: launch.run(ranks.card_path_rank, n, f0, solid, CFG.u0,
                          CFG.tau, PLANS, LIMITS, device="cpu")
            for n in RANKS}


@pytest.mark.parametrize("card", sorted(LIMITS))
@pytest.mark.parametrize("n", RANKS)
def test_card_path_with_the_extended_word(card_path, lattice, n, card):
    """The card's path on the CPU: each round's kernel call (here the plain
    step reading every mask from the cell word, as the kernels do) on the
    extended block with the extended global word gives the plain step's
    lattice, one launch a round of the kernel that holds the block and
    one word launch a rank and call."""
    f0, solid = lattice
    got, counts = card_path[n][card]
    for (steps, _halo), out in zip(PLANS, got):
        want = core.lbm_step(torch.as_tensor(f0), torch.as_tensor(solid),
                             CFG.u0, CFG.tau, steps=steps)
        np.testing.assert_allclose(out, want.numpy(), rtol=RTOL, atol=ATOL)
    rounds = sum(-(-steps // max(1, min(halo, steps, CFG.ny // n)))
                 for steps, halo in PLANS)
    want = [0, rounds] if card == "tiled" else [rounds, 0]
    assert counts == [want + [len(PLANS)]] * n


@pytest.mark.parametrize("k", [1, 5, 8, 12])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_extended_word_rows(lattice, n, k):
    _f0, solid = lattice
    solid = torch.as_tensor(solid)
    word = core.cell_word(solid)
    rows = CFG.ny // n
    bounce = (1 << 9) - 1
    for rank in range(n):
        r0, r1 = rank * rows, (rank + 1) * rows
        ext = extended_rows(word, r0, r1, k)
        assert ext.dtype == torch.uint16 and ext.shape == (rows + 2 * k,
                                                           CFG.nx)
        # Every row the round keeps is the global word's.
        assert torch.equal(ext[k:k + rows], word[r0:r1])
        # Its bounce bits are the extended mask's but in the outermost
        # halo rows, whose streaming sources lie outside the block.
        own = core.cell_word(extended_rows(solid, r0, r1, k))
        e, o = ext.to(torch.int32) & bounce, own.to(torch.int32) & bounce
        assert torch.equal(e[1:-1], o[1:-1])
        # The extended mask's own word marks its first and last rows as
        # edges; the global word marks the lattice's.
        edge = 1 << core.EDGE_BIT
        ext_edge = (ext.to(torch.int32) & edge) != 0
        rows_ext = torch.arange(r0 - k, r1 + k) % CFG.ny
        want_rows = (rows_ext == 0) | (rows_ext == CFG.ny - 1)
        assert torch.equal(ext_edge[:, 1:-1].any(1), want_rows)


def test_dryrun_sharded_step_two_ranks():
    assert launch.run(ranks.dryrun_rank, 2, device="cpu") == []


def test_rows_must_divide():
    f = torch.zeros((9, 30, 16))
    with pytest.raises(AssertionError, match="not divisible"):
        sharded_lbm_steps(Mesh(0, 4, torch.device("cpu")), f,
                          torch.zeros((30, 16)), 0.06, 0.58, 4)
