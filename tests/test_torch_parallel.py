"""The port's sharded polar (``airfoil_tpu_torch.parallel``) against the JAX
reference's (``airfoil_tpu.parallel``), on the CPU. Ranks are gloo
processes started by ``parallel.launch.run``; the reference runs on the
virtual CPU devices of ``tests/conftest.py``.

- ``shard_polar_inputs`` equals the reference's on meshes of 1, 2, 4 and
  8 devices: the sorted and padded alphas and Re, the pad, ``unsort`` and
  each rank's block, for sorted and unsorted input and input with repeats;
- on one block, with the solver stages scripted the same way in both
  packages (``tests/torch_parallel_ranks.py``; the per-point states
  carried across as tensors): ``_local_walk``, ``_local_rescue`` (run and
  skipped) and ``_select_three_strategy`` give the reference's answers,
  the inviscid fill within 1e-5 and everything else equal;
- ``sharded_polar`` end to end with those stages over 2 and 4 spawned
  ranks (and the one-rank mesh outside a process group) gives the
  reference's ``sharded_polar`` on as many devices, point for point;
- the launcher and the mesh's collectives: the ring exchange over 2, 3
  and 4 ranks, the mesh record, and the refusals: NCCL with more ranks
  than cards raises before any process starts, a failing rank fails the
  call with its traceback.

The slow tier adds the live (unscripted) sharded polar at a reduced width,
the graft entry's solve and ``dryrun_multichip`` over 2 ranks: on a CPU the
plain march makes each take minutes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airfoil_tpu.parallel.mesh as JM
import airfoil_tpu.polar.sweep as JS
import airfoil_tpu_torch.parallel.mesh as PM
import airfoil_tpu_torch.polar.sweep as TS
import torch_parallel_ranks as ranks
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.parallel import Mesh, launch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "torch_parallel.json")
CPU = torch.device("cpu")
INPUTS = {
    "sorted": np.arange(-8.0, 8.0, 1.0),
    "unsorted": np.array([4.0, -2.0, 10.0, 0.0, 7.0]),
    "repeats": np.array([3.0, 1.0, 3.0, -2.0, 1.0, 1.0, 5.0, -2.0, 9.0]),
}
# Unsorted, with a repeat, failures (alpha % 3 == 0) on every side of the
# walk's alpha-4 line and past the rescue's alpha-12 line.
POLAR_ALPHAS = np.array([5.0, -3.0, 9.0, 0.0, 2.0, 11.0, -1.0, 6.0, 3.0,
                         8.0, 0.0, 12.0, 4.0, 15.0], np.float32)
OUTPUTS = ("cl", "cd", "cdp", "cm", "mode", "converged", "xtr_upper",
           "xtr_lower", "sep_fraction")


@pytest.fixture(scope="module")
def coords():
    return np.asarray(naca4(2, 4, 12, 80), np.float32)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_polar_inputs_equal_jax(n, name):
    alphas = INPUTS[name].astype(np.float32)
    re = np.linspace(5e5, 2e6, len(alphas)).astype(np.float32)
    mesh = JM.batch_mesh(jax.devices()[:n])
    a_sh, re_sh, pad, unsort = JM.shard_polar_inputs(mesh, alphas, re)
    blocks = [PM.shard_polar_inputs(Mesh(r, n, CPU), alphas, re)
              for r in range(n)]
    for got in blocks:
        assert got[2] == pad
        np.testing.assert_array_equal(got[3], unsort)
    np.testing.assert_array_equal(
        np.concatenate([b[0].numpy() for b in blocks]), np.asarray(a_sh))
    np.testing.assert_array_equal(
        np.concatenate([b[1].numpy() for b in blocks]), np.asarray(re_sh))
    # Each rank's block is the reference's shard on its device.
    shards = sorted(a_sh.addressable_shards, key=lambda s: s.index[0].start)
    for r, shard in enumerate(shards):
        np.testing.assert_array_equal(blocks[r][0].numpy(),
                                      np.asarray(shard.data))
    np.testing.assert_array_equal(np.sort(alphas, kind="stable")[unsort],
                                  alphas)


def _jax_points(op, alphas, reynolds):
    m1, ok, st1 = ranks.points_script(alphas, jnp)
    return m1, (ok, st1)


@pytest.fixture
def scripted_jax(monkeypatch):
    """The reference's sharded stages scripted (its jitted kernels retrace
    under the patch, so their caches are cleared around it)."""
    monkeypatch.setattr(JM, "_local_points", _jax_points)
    monkeypatch.setattr(JM, "_walk", ranks.walk_script)
    monkeypatch.setattr(JM, "solve_polar_point", ranks.rescue_script)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def scripted_port(monkeypatch):
    monkeypatch.setattr(PM, "_local_points", ranks.torch_points)
    monkeypatch.setattr(PM, "_walk", ranks.walk_script)
    monkeypatch.setattr(PM, "solve_polar_points", ranks.rescue_script)


def _equal(got, want, fields, inviscid=("cl", "cm")):
    for name, g, w in zip(fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        if name in inviscid:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


BLOCK = np.array([-3.0, -1.0, 0.0, 2.0, 3.0, 5.0, 6.0, 12.0], np.float32)
M8 = ("cl", "cd", "cdp", "cm", "converged", "xtr_upper", "xtr_lower",
      "sep_fraction")


def test_local_stages_equal_jax(coords, scripted_jax, scripted_port,
                                monkeypatch):
    """One block through the walk, the rescue (run: the block has
    failures) and the selection; then the rescue skipped, building no
    smoothed operator."""
    re = np.full(BLOCK.shape, 1e6, np.float32)
    op_j = JS._op_kernel(jnp.asarray(coords), 160)[0]
    op_t = TS._op_kernel(torch.as_tensor(coords), 160)[0]
    a_j, re_j = jnp.asarray(BLOCK), jnp.asarray(re)
    a_t, re_t = torch.as_tensor(BLOCK), torch.as_tensor(re)
    m1_j, (nok_j, st_j) = JM._local_points(op_j, a_j, re_j)
    m1_t, (nok_t, st_t) = PM._local_points(op_t, a_t, re_t)

    want = JM._local_walk(op_j, a_j, re_j, m1_j, nok_j, st_j)
    got = PM._local_walk(op_t, a_t, re_t, m1_t, nok_t, st_t)
    _equal(got[0], want[0], M8, inviscid=("cl",))   # cl carries cli
    _equal(got[1:], want[1:], ("use1", "cl", "cm"))
    use1_j, use1_t = want[1], got[1]
    assert not bool(use1_t.all()) and bool(use1_t.any())

    v2_j = JM._local_rescue(op_j, a_j, re_j, use1_j)
    c_t = torch.as_tensor(coords)
    v2_t = PM._local_rescue(c_t, 160, a_t, re_t, use1_t)
    _equal(v2_t, v2_j, M8, inviscid=())
    assert bool(v2_t[4].any()) and not bool(v2_t[4].all())
    out_j = JM._select_three_strategy(want[0], use1_j, v2_j, *want[2:])
    out_t = PM._select_three_strategy(got[0], use1_t, v2_t, *got[2:])
    _equal(out_t, out_j, OUTPUTS)
    assert set(np.asarray(out_t[4]).tolist()) == {0, 1, 2}
    assert out_t[4].dtype == torch.int32 and out_t[5].dtype == torch.bool

    def no_operator(*_args):
        raise AssertionError("a clean block builds no smoothed operator")
    monkeypatch.setattr(PM, "_op_kernel_smoothed", no_operator)
    clean = jnp.ones(BLOCK.shape, bool)
    skip_j = JM._local_rescue(op_j, a_j, re_j, clean)
    skip_t = PM._local_rescue(c_t, 160, a_t, re_t,
                              torch.ones(BLOCK.shape, dtype=torch.bool))
    _equal(skip_t, skip_j, M8, inviscid=())
    assert not bool(skip_t[4].any())


def _jax_sharded(coords, n):
    mesh = JM.batch_mesh(jax.devices()[:n])
    return JM.sharded_polar(mesh, coords, POLAR_ALPHAS, 1e6)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_polar_scripted_equals_jax(coords, scripted_jax, n):
    want = _jax_sharded(coords, n)
    got = launch.run(ranks.scripted_polar_rank, n, coords, POLAR_ALPHAS,
                     1e6, device="cpu")
    _equal(got, want, OUTPUTS)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
    assert set(got[4].tolist()) == {0, 1, 2}


def test_sharded_polar_one_rank_scripted_equals_jax(coords, scripted_jax,
                                                    scripted_port):
    want = _jax_sharded(coords, 1)
    got = PM.sharded_polar(PM.batch_mesh(device="cpu"), coords,
                           POLAR_ALPHAS, 1e6)
    _equal(got, want, OUTPUTS)
    assert set(PM.stage_seconds) == {"points", "walk", "rescue", "select",
                                     "gather"}


def test_exchange_ring():
    for n in (2, 3, 4):
        got = launch.run(ranks.exchange_rank, n, device="cpu")
        for r in range(n):
            np.testing.assert_array_equal(got[r][0], [(r - 1) % n, 1])
            np.testing.assert_array_equal(got[r][1], [(r + 1) % n, -1])


def test_mesh_record():
    got = launch.run(ranks.mesh_rank, 2, device="cpu")
    assert got == {"backend": "gloo", "staged": False, "device": "cpu",
                   "ranks": [[0, 2], [1, 2]]}


def test_launch_refuses_nccl_with_shared_cards(monkeypatch):
    spawned = []
    monkeypatch.setattr(launch.mp, "spawn",
                        lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl needs a card a rank"):
        launch.run(ranks.mesh_rank, 2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="nccl needs a card a rank"):
        launch.run(ranks.mesh_rank, 4, device="cuda")
    with pytest.raises(ValueError, match="nccl runs on cuda"):
        launch.run(ranks.mesh_rank, 1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        launch.run(ranks.mesh_rank, 1, device="cpu", backend="mpi")
    assert spawned == []


def test_launch_fails_with_a_failing_rank():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch.run(ranks.failing_rank, 2, device="cpu")


# ── the hold of a sharded polar point (``chip_smoke.py``, phase 27) ────────

_M0 = {"cl": 0.5, "cd": 0.006, "cm": -0.05, "xtr_upper": 0.4,
       "xtr_lower": 0.9, "mode": 0, "converged": True}
# Member 1 lies 2 bars of CL off member 0; member 2 is alone in its mode.
_SPREAD_MEMBERS = [_M0, dict(_M0, cl=0.55),
                   dict(_M0, mode=1, cl=0.9, cd=0.02)]


def test_members_spread_passes_over_a_member_alone_in_its_verdicts():
    import chip_smoke as cs

    assert cs.members_spread(_SPREAD_MEMBERS) == pytest.approx(2.0)
    assert cs.members_spread(_SPREAD_MEMBERS[:1]) == 0.0


@pytest.mark.parametrize("rec, held, says", [
    (dict(_M0, cd=0.0061), True, "nearest member 0"),
    (dict(_M0, cm=-0.035), True, "held by no member: nearest member 0 at "
                                 "1.500 bars, the members' own spread 2.000"),
    (dict(_M0, cm=-0.02), False, "more than the members' spread"),
    (dict(_M0, mode=1, cl=0.5), False, "more than the members' spread"),
    (dict(_M0, mode=2), False, "not among the verdicts"),
    (dict(_M0, converged=False), False, "not among the verdicts"),
])
def test_held_to_spread(rec, held, says):
    """A point held by no member passes only with the verdicts of one and
    no farther from its nearest such member than the members' own
    spread."""
    import chip_smoke as cs

    fails, note = cs.held_to_spread(rec, {"members": _SPREAD_MEMBERS})
    assert (fails == []) == held
    assert says in (note if held else fails[0])


# ── the slow tier: the live solves ─────────────────────────────────────────

BARS = {"cl": (0.025, 0.0), "cd": (0.0, 0.05), "cm": (0.01, 0.0),
        "xtr_upper": (0.05, 0.0), "xtr_lower": (0.05, 0.0)}


def _within(got: dict, want: dict, bars) -> bool:
    return all(abs(got[f] - want[f]) <= a + r * abs(want[f])
               for f, (a, r) in bars.items())


@pytest.mark.slow
def test_sharded_polar_live_reduced_width(monkeypatch):
    """The unscripted sharded polar at 64 panels and 32 stations over 2
    ranks against the reference's on 2 devices, both at Re (1 + k 2^-23),
    k = -2..2 (each package's rounding ensemble). At this width most
    points are knife edges for both: which transition basin a solve lands
    in turns on float32 rounding, and the reference's own answer moves by
    up to 2-3 bars when only its lane count changes. So the two ensembles
    are compared, not two runs: every port member carries the verdicts of
    one reference member; at every point the ensembles share a basin (one
    port member held jointly to one reference member, ``held_to_polar``);
    and on no barred field does the port's ensemble sit off the
    reference's, averaged over the points, by more than one bar (a CD 15 %
    high sits over 2 bars off; the upper transition comes closest to the
    bound, its basins at alpha -2 lying 0.2 c apart)."""
    import chip_smoke as cs

    c = np.asarray(naca4(2, 4, 12, 40), np.float32)
    alphas = np.array([-2.0, 0.0, 2.0, 4.0], np.float32)
    res = [float(np.float32(1e6) * (1.0 + k * 2.0 ** -23))
           for k in (0, -2, -1, 1, 2)]
    monkeypatch.setattr(JM, "_N_STATIONS", 32)
    monkeypatch.setattr(JS, "_N_STATIONS", 32)
    jax.clear_caches()
    mesh = JM.batch_mesh(jax.devices()[:2])
    runs = [JM.sharded_polar(mesh, c, alphas, re, n_panels=64) for re in res]
    jax.clear_caches()
    ports = launch.run(ranks.live_polar_rank, 2, c, alphas, res, 64, 32,
                       device="cpu")

    def members(outs, i):
        return [{f: float(np.asarray(out[j])[i])
                 for j, f in enumerate(OUTPUTS)} for out in outs]
    off = []
    offset = {f: 0.0 for f in BARS}
    for i, alpha in enumerate(alphas):
        ref = {"members": members(runs, i)}
        port = members(ports, i)
        for rec in port:
            assert np.isfinite(list(rec.values())).all(), rec
            fails, _ = cs.held_to_polar(rec, ref)
            assert not any("not among the verdicts" in f for f in fails), (
                alpha, rec, ref)
        if all(cs.held_to_polar(rec, ref)[0] for rec in port):
            off.append((float(alpha), port, ref["members"]))
        for f, (a, r) in BARS.items():
            want = np.mean([m[f] for m in ref["members"]])
            got = np.mean([m[f] for m in port])
            offset[f] += (got - want) / (a + r * abs(want)) / len(alphas)
    print(f"the port's ensemble off the reference's, in bars: {offset}")
    assert not off, off
    assert all(abs(v) <= 1.0 for v in offset.values()), offset


@pytest.mark.slow
def test_graft_entry_held_to_jax():
    """``entry(device="cpu")``'s [cl, cd, cm] jointly within the bars of one
    member of the reference's rounding ensemble (its point is a knife edge:
    CL spreads 0.77-0.80 over 9 members), the live reference run among
    them."""
    import __graft_entry__ as jax_graft
    from airfoil_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (3,) and out.device.type == "cpu"
    got = dict(zip(("cl", "cd", "cm"), out.tolist()))
    jfn, jargs = jax_graft.entry()
    live = dict(zip(("cl", "cd", "cm"),
                    np.asarray(jax.jit(jfn)(*jargs)).tolist()))
    with open(GOLDEN) as fh:
        members = json.load(fh)["entry"]["members"]
    bars = {f: BARS[f] for f in ("cl", "cd", "cm")}
    assert any(_within(got, m, bars) for m in members + [live]), (got, live)


@pytest.mark.slow
def test_dryrun_multichip_two_ranks(capsys):
    from airfoil_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK on 2 devices" in capsys.readouterr().out
