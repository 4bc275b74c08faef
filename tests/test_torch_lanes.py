"""The direct coupled solve over geometry lanes (``solve_viscous`` on an
operator with a lane axis, the parser benchmark's solve) on the CPU.

- Operators: ``repanel`` -> ``panel_geometry`` -> ``build_operator`` of a
  stack of loops equal, lane by lane and bit for bit, the one-geometry
  operators, and a degenerate loop (all zeros, as the benchmark pads a file
  without a loop) gives NaNs without raising and without touching the
  other lanes.
- The solve: each lane equals the one-geometry ``solve_viscous`` of its
  loop bit for bit (every output field), the degenerate lane included; a
  list of operators is the same solve; each coupling pass is one side march
  of 2B lanes and one wake march of B lanes. (Bit for bit below 16
  geometries: from 32 side lanes torch's CPU ``pow`` in the march's
  closures takes a vectorised path that rounds differently.)
- Against JAX's ``vmap`` of its solve over the same loops (the parser
  benchmark's, at a reduced shape: 64 panels, 24 stations, 8 wake
  stations, 6 passes), tripped at x 0.05 where the reference is no knife
  edge, at the bars of ``tests/test_torch_tripped.py``: CL within 0.025,
  CD within 5 %, Cm within 0.01, x_transition within 0.05 c, ``converged``
  and the benchmark's plausibility verdict equal.
- Slow tier: the two chunks of the 500-file benchmark that hold
  ``af0013_naca4_selig.dat`` and ``af0425_very_thick_selig.dat`` at the
  benchmark's full shape, raw and parsed, against the JAX members of
  ``tests/golden/torch_bench.json``: verdicts off all three members at
  most the members' own flip rate S.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.inviscid import build_operator as jbuild
from airfoil_tpu.paneling import panel_geometry as jpanel
from airfoil_tpu.paneling import repanel as jrepanel
from airfoil_tpu.viscous import solve_viscous as jsolve
from airfoil_tpu_torch.bench import parser_benchmark as pb
from airfoil_tpu_torch.bench.corpus import generate_corpus
from airfoil_tpu_torch.geometry import parse_dat_file
from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.paneling import panel_geometry, repanel
from airfoil_tpu_torch.viscous import coupled, kernel
from chip_smoke import recording
from test_torch_coupled import BARS

N_PANELS = 64
SHAPE = {"n_stations": 12, "n_wake": 4, "coupling_iters": 3}
TRIPPED_SHAPE = {"n_stations": 24, "n_wake": 8, "coupling_iters": 6}
TRIP_X = 0.05
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_bench.json")
_CACHE = {}


def _loops(tmp_root) -> np.ndarray:
    """Three parsed loops of the benchmark's corpus, resampled as the
    benchmark does, and the padding of a file without a loop."""
    if "loops" not in _CACHE:
        files = generate_corpus(str(tmp_root), n=12, seed=0)
        parsed = [np.asarray(parse_dat_file(p)[0]) for p in files
                  if "multi" not in p and "too_few" not in p][:3]
        arr, ok = pb.resample(parsed + [None])
        assert ok == [True] * 3 + [False]
        _CACHE["loops"] = arr
    return _CACHE["loops"]


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    return _loops(tmp_path_factory.mktemp("corpus"))


def _one_op(loop):
    return build_operator(panel_geometry(*repanel(torch.as_tensor(loop),
                                                  N_PANELS)))


def _same(a, b) -> bool:
    """Equal bit for bit, a NaN equal to any NaN (its sign and payload
    carry nothing)."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0.0).view(torch.int32),
        b.masked_fill(nan, 0.0).view(torch.int32))


def test_interp_nan_query_as_jax():
    """A NaN query interpolates to NaN, as ``jnp.interp`` (whose
    ``searchsorted`` puts it past the last point), also where the first
    interval has zero length: a degenerate lane's stations (NaN arc
    positions) then stay NaN instead of taking the first value."""
    from airfoil_tpu_torch.numerics import interp

    xp = np.array([0.0, 0.0, 1.0, 2.0], np.float32)
    fp = np.array([5.0, 6.0, 7.0, 8.0], np.float32)
    x = np.array([np.nan, 0.5, -1.0, 3.0, 1.0], np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = interp(torch.as_tensor(x), torch.as_tensor(xp),
                 torch.as_tensor(fp)).numpy()
    np.testing.assert_array_equal(got, want)
    lanes = interp(torch.as_tensor(np.stack([x, x])),
                   torch.as_tensor(np.stack([xp, xp])),
                   torch.as_tensor(np.stack([fp, fp]))).numpy()
    np.testing.assert_array_equal(lanes, np.stack([want, want]))
    assert np.isnan(got[0])


def test_nan_matrix_factors_to_nan(tmp_path):
    """A loop whose influence matrix has NaN entries (the raw path of a
    noisy file, its stray point kept) factors to NaN in every lane that
    holds it, as JAX's does, so its solve is NaN as the reference's; the
    other lanes are untouched."""
    files = generate_corpus(str(tmp_path), n=13, seed=0)
    assert files[12].endswith("af0012_thick_te_noisy.dat")
    arr = pb.resample([np.asarray(pb.raw_coords_from_file(files[12])),
                       np.asarray(parse_dat_file(files[12])[0])])[0]
    ops = build_operator(panel_geometry(*repanel(torch.as_tensor(arr),
                                                 pb.N_PANELS)))
    ref = jbuild(jpanel(*jrepanel(jnp.asarray(arr[0]), pb.N_PANELS)))
    assert np.isnan(np.asarray(ref.a_full)).any()
    assert torch.isnan(ops.a_full[0]).any() and torch.isnan(ops.lu[0]).all()
    assert not np.isfinite(np.asarray(ref.due_dsigma)).any()
    assert not torch.isfinite(ops.due_dsigma[0]).any()
    assert torch.isfinite(ops.lu[1]).all()
    assert torch.isfinite(ops.due_dsigma[1]).all()


def test_lane_operators_equal_one_geometry(loops):
    ops = build_operator(panel_geometry(*repanel(torch.as_tensor(loops),
                                                 N_PANELS)))
    for i, loop in enumerate(loops):
        one = _one_op(loop)
        for f in one._fields[1:]:
            assert _same(getattr(ops, f)[i], getattr(one, f)), (i, f)
        for f in one.pan._fields:
            assert _same(getattr(ops.pan, f)[i], getattr(one.pan, f)), (i, f)
    # The padding lane's system is singular: its sensitivities are not
    # finite, the others' are.
    assert not torch.isfinite(ops.due_dsigma[-1]).any()
    assert torch.isfinite(ops.due_dsigma[:-1]).all()


def _fields(r):
    out = {f: getattr(r, f) for f in ("cl", "cd", "cdp", "cm", "cp",
                                      "converged", "sep_fraction", "sigma",
                                      "sigma_wake")}
    for side in ("upper", "lower"):
        for f, v in getattr(r, side)._asdict().items():
            out[f"{side}.{f}"] = v
    return out


def test_lane_solve_equals_one_geometry_solves(loops):
    ops = build_operator(panel_geometry(*repanel(torch.as_tensor(loops),
                                                 N_PANELS)))
    with recording(kernel) as calls:
        lanes = coupled.solve_viscous(ops, pb.BENCH_ALPHA, pb.BENCH_REYNOLDS,
                                      **SHAPE)
    b = len(loops)
    passes = SHAPE["coupling_iters"] + 1
    assert [c[0].shape for c in calls["march_side"]] == \
        [(2 * b, SHAPE["n_stations"])] * passes
    assert [c[0].shape for c in calls["march_wake"]] == \
        [(b, SHAPE["n_wake"])] * passes
    got = _fields(lanes)
    for i, loop in enumerate(loops):
        want = _fields(coupled.solve_viscous(
            _one_op(loop), pb.BENCH_ALPHA, pb.BENCH_REYNOLDS, **SHAPE))
        for f, v in want.items():
            assert _same(got[f][i], v), (i, f)
    assert not lanes.converged[-1] and torch.isnan(lanes.cl[-1])
    assert torch.isfinite(lanes.cl[:-1]).all()
    listed = coupled.solve_viscous([_one_op(loop) for loop in loops[:2]],
                                   pb.BENCH_ALPHA, pb.BENCH_REYNOLDS,
                                   **SHAPE)
    for f, v in _fields(listed).items():
        assert _same(v, got[f][:2]), f


def _spread_free(members: np.ndarray, abs_bar: float, rel_bar: float):
    """Lanes whose members (K, B) lie within a tenth of the bar."""
    spread = members.max(0) - members.min(0)
    return spread <= 0.1 * (abs_bar + rel_bar * np.abs(members[1]))


def test_lane_solve_tripped_against_jax_vmap(tmp_path):
    """Eight parsed loops of the corpus. The reference's own rounding
    spread at this point decides which lanes are held: a lane is held
    where JAX's solves at Re (1 + k 2^-23), k = -1, 0, 1, agree on
    ``converged`` and the verdict and lie within a tenth of each bar (as
    ``chip_smoke.py`` holds the card's tripped chunks)."""
    files = generate_corpus(str(tmp_path), n=16, seed=0)
    loops = [np.asarray(parse_dat_file(p)[0]) for p in files
             if not any(k in p for k in ("multi", "too_few", "non_mono"))]
    arr = pb.resample(loops[:8])[0]
    ops = build_operator(panel_geometry(*repanel(torch.as_tensor(arr),
                                                 N_PANELS)))
    r = coupled.solve_viscous(ops, pb.BENCH_ALPHA, pb.BENCH_REYNOLDS,
                              x_forced_transition=TRIP_X, **TRIPPED_SHAPE)

    @jax.jit
    def solve(batch, re):
        def one(coords):
            op = jbuild(jpanel(*jrepanel(coords, N_PANELS)))
            res = jsolve(op, pb.BENCH_ALPHA, re, x_forced_transition=TRIP_X,
                         **TRIPPED_SHAPE)
            ok = (jnp.isfinite(res.cl) & jnp.isfinite(res.cd)
                  & (jnp.abs(res.cl) < 2.5) & (res.cd > 1e-4)
                  & (res.cd < 0.08) & (res.sep_fraction < 0.5))
            return {"cl": res.cl, "cd": res.cd, "cm": res.cm,
                    "xtr_upper": res.upper.x_transition,
                    "xtr_lower": res.lower.x_transition,
                    "converged": res.converged, "plausible": ok}
        return jax.vmap(one)(batch)

    members = [jax.device_get(solve(jnp.asarray(arr),
                                    pb.BENCH_REYNOLDS * (1 + k * 2.0 ** -23)))
               for k in (-1, 0, 1)]
    ref = {f: np.stack([m[f] for m in members]) for f in members[0]}
    port = {"cl": r.cl, "cd": r.cd, "cm": r.cm,
            "xtr_upper": r.upper.x_transition,
            "xtr_lower": r.lower.x_transition, "converged": r.converged,
            "plausible": pb.plausible(r)}
    port = {f: v.numpy() for f, v in port.items()}
    held = ((ref["converged"] == ref["converged"][1]).all(0)
            & (ref["plausible"] == ref["plausible"][1]).all(0))
    for f, bars in BARS.items():
        held &= _spread_free(ref[f], *bars)
    assert held.sum() >= 4, held
    for f, (abs_bar, rel_bar) in BARS.items():
        a, b = port[f][held], ref[f][1][held]
        assert (np.abs(a - b) <= abs_bar + rel_bar * np.abs(b)).all(), \
            (f, a, b)
    for f in ("converged", "plausible"):
        np.testing.assert_array_equal(port[f][held], ref[f][1][held])
    assert (port["xtr_upper"][held] < 0.1).all()


@pytest.mark.slow
@pytest.mark.parametrize("path", ["raw", "parsed"])
def test_knife_edge_chunks_against_members(path, tmp_path):
    """The chunks of af0013 (chunk 0) and af0425 (chunk 13) at the
    benchmark's full shape, held as ``chip_smoke.py`` holds the card: O,
    the verdicts off all three JAX members, at most S."""
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    files = generate_corpus(str(tmp_path), n=500, seed=0)
    if path == "raw":
        geoms = [np.asarray(g) if len(g) >= 5 else None
                 for g in map(pb.raw_coords_from_file, files)]
    else:
        geoms = []
        for p in files:
            try:
                geoms.append(np.asarray(parse_dat_file(p)[0]))
            except Exception:
                geoms.append(None)
    arr, ok = pb.resample(geoms)
    members = [gold["members"][str(k)][path] for k in gold["members_k"]]
    off = []
    for c in (0, 13):
        lanes = slice(c * pb.CHUNK, (c + 1) * pb.CHUNK)
        r = pb.solve_chunk(pb.chunk_operators(arr[lanes], "cpu"))
        verdicts = pb.plausible(r).tolist()
        for i, v in zip(range(lanes.start, lanes.stop), verdicts):
            v = v and ok[i] and not gold["multi_element"][i]
            if all(v != m["verdict"][i] for m in members):
                off.append((gold["names"][i], float(r.cl[i - lanes.start]),
                            float(r.cd[i - lanes.start])))
        print(path, c, [(gold["names"][i], float(r.cl[i - lanes.start]),
                         float(r.cd[i - lanes.start]), verdicts[i - lanes.start])
                        for i in (13, 425) if lanes.start <= i < lanes.stop])
    assert len(off) <= gold["flip_rate"]["S"], off
