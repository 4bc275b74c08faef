"""The LM iteration's graph body (``newton._lm_body``, what
``viscous.graphs`` captures on the card) on the CPU, where it runs
eagerly, at 64 panels, 32 stations a side and 8 wake stations.

- The body on a system's flat list (``[zz, lam, *system.lm_tensors()]``)
  equals ``_System.lm_step`` bit for bit, at 1 lane and at 8 (a polar
  bucket's), and a whole ``_lm_rounds`` through it equals the same rounds
  run by a loop of ``lm_step`` (the round's code before the graphs) bit
  for bit: the best state, its rms and each lane's rounds. On the CPU no
  graph is captured and none replayed.
- A system rebuilt from the flat list (``_System.of_lm_tensors``) reads
  every tensor it was given: seeded noise on any one input alone changes
  the iteration's output. The states are seeded random walks (as in
  ``test_torch_newton.py``), the trips pulled forward so that the trip
  coordinates matter, and the first step from them is accepted.
- The key (``graphs.lm_key``): polars of 5 and 7 points (both in bucket
  8) share one; 1 and 8 lanes, two station counts, a shared and a stacked
  operator, two panel counts do not.
"""

import numpy as np
import pytest
import torch

from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.paneling import panel_geometry, repanel
from airfoil_tpu_torch.polar import sweep
from airfoil_tpu_torch.viscous import graphs, newton

M_S, N_W, N_PANELS = 32, 8, 64
RE, N_CRIT, TRIP_U, TRIP_L = 1e6, 9.0, 0.3, 0.4
_OPS = {}


def _op(code: str = "2412", n_panels: int = N_PANELS):
    if (code, n_panels) not in _OPS:
        coords = naca4(int(code[0]), int(code[1]), int(code[2:]), 60)
        _OPS[code, n_panels] = build_operator(panel_geometry(
            *repanel(coords, n_panels, device="cpu")))
    return _OPS[code, n_panels]


def seeded_states(p: int, seed: int) -> torch.Tensor:
    """(P, n3) states: sides thickening from the stagnation point with Hk
    1.4-4 and n rising through n_crit, a wake of Hk 1.1-2.5, n = 0."""
    rng = np.random.default_rng(seed)

    def side():
        f = np.linspace(0.0, 1.0, M_S)
        theta = (3e-5 + 2e-3 * f ** 1.3) * np.exp(
            0.05 * rng.standard_normal(M_S))
        hk = rng.uniform(1.4, 4.0, M_S)
        ct = 10.0 ** rng.uniform(-4.0, -1.5, M_S)
        n = np.sort(rng.uniform(0.0, 13.0, M_S))
        return np.stack([np.log(theta), np.log(theta * hk), np.log(ct), n],
                        1).ravel()

    def wake():
        theta = 4e-3 * (1.0 + 0.3 * rng.random(N_W))
        return np.stack([np.log(theta),
                         np.log(theta * rng.uniform(1.1, 2.5, N_W)),
                         np.log(10.0 ** rng.uniform(-3.0, -1.5, N_W)),
                         np.zeros(N_W)], 1).ravel()

    return torch.tensor(np.stack([np.concatenate([side(), side(), wake()])
                                  for _ in range(p)]).astype(np.float32))


def make_system(p: int, alphas=None, op=None, m_s: int = M_S,
                zz_lin=None, l_mat=None):
    alphas = np.linspace(-2.0, 6.0, p) if alphas is None else alphas
    op = _op() if op is None else op
    lane_op, _cl, vt0, wop, grid = newton._lane_setup(
        op, torch.tensor(np.asarray(alphas, np.float32)), m_s, N_W)

    def lanes(v):
        return torch.full((p,), v, dtype=torch.float32)

    return newton._System(lane_op, wop, grid, vt0, 1.0 / lanes(RE), m_s, N_W,
                          lanes(N_CRIT), lanes(TRIP_U), lanes(TRIP_L),
                          zz_lin=zz_lin, l_mat=l_mat)


@pytest.fixture(scope="module")
def systems():
    """{P: (system, zz, lam)} at 1 and 8 lanes."""
    out = {}
    for p in (1, 8):
        zz = seeded_states(p, 10 + p)
        out[p] = (make_system(p, zz_lin=zz), zz,
                  torch.full((p,), 1e-3, dtype=torch.float32))
    return out


def _flat(system, zz, lam) -> list:
    return [zz, lam, *system.lm_tensors()]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("p", [1, 8])
def test_body_equals_lm_step(systems, p):
    system, zz, lam = systems[p]
    want = system.lm_step(zz, lam)
    got = newton._lm_body(M_S, N_W, _flat(system, zz, lam))
    assert _same(got, want)
    # The first step from the seeded states is taken, in every lane.
    assert (want[0] != zz).any(-1).all()


@pytest.mark.parametrize("p", [1, 8])
def test_lm_rounds_through_body(systems, p, monkeypatch):
    system, zz, _lam = systems[p]
    before = (dict(graphs.captures), dict(graphs.replays))
    got = newton._lm_rounds(system, zz, 3, 2)
    assert (dict(graphs.captures), dict(graphs.replays)) == before

    def loop(zz, lam, iters):
        for _ in range(iters):
            zz, lam = system.lm_step(zz, lam)
        return zz, lam

    monkeypatch.setattr(system, "run_lm", loop)
    want = newton._lm_rounds(system, zz, 3, 2)
    assert _same(got, want)
    assert int(got[2].max()) == 2


@pytest.mark.parametrize("field", ["zz", "lam", *newton._LMTensors._fields])
def test_rebuilt_system_reads_every_tensor(systems, field):
    system, zz, lam = systems[1]
    flat = _flat(system, zz, lam)
    base = newton._lm_body(M_S, N_W, flat)
    names = ["zz", "lam", *newton._LMTensors._fields]
    i = names.index(field)
    t = flat[i]
    rng = np.random.default_rng(i)
    noise = torch.tensor(rng.standard_normal(tuple(t.shape)).astype(
        np.float32))
    scale = 1e-2 * float(t.abs().max()) + 1e-4
    flat[i] = t + scale * noise
    out = newton._lm_body(M_S, N_W, flat)
    assert not _same(out, base), field


def test_rebuilt_system_holds_only_the_flat_tensors(systems):
    system, _zz, _lam = systems[8]
    t = system.lm_tensors()
    rebuilt = newton._System.of_lm_tensors(t, M_S, N_W)
    assert all(a is b for a, b in zip(rebuilt.lm_tensors(), t))
    assert rebuilt.grid.x_u is None and rebuilt.op.pan.xm is None
    assert rebuilt.lanes == system.lanes == (8,)


def test_key():
    zeros = {}

    def key(p, m_s=M_S, op=None):
        if (p, m_s) not in zeros:
            s_m = 2 * m_s + N_W
            zeros[p, m_s] = torch.zeros(p, s_m, s_m)
        return graphs.lm_key(make_system(p, op=op, m_s=m_s,
                                         l_mat=zeros[p, m_s]))

    k5, k7 = (key(sweep._bucket_size(n)) for n in (5, 7))
    assert k5 == k7 == key(8)
    assert len({key(1), key(8), key(8, m_s=24)}) == 3
    assert key(8, op=[_op("2412")] * 8) != key(8)
    assert key(1, op=_op("2412", 48)) != key(1)


def test_run_lm_refuses_other_devices():
    flat = [torch.empty(2, 4, device="meta"), torch.empty(2, device="meta")]
    with pytest.raises(ValueError):
        graphs.run_lm(("meta",), lambda f: (f[0], f[1]), flat, 1)
