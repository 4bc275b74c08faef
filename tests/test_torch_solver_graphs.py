"""The solver's programs of the compiled-program layer (``viscous.graphs``)
on the CPU, where their bodies run eagerly, at 64 panels, 32 stations a
side and 8 wake stations: the direct solve ``coupled.solve_viscous``
(``_direct_body``) and the Newton solve's set-up (``newton._prepare_body``),
round (``_reproject_body``, ``_settle_body``) and answer
(``_answer_body``).

- The direct body on a flat list made here, not by ``solve_viscous``'s
  host part, equals ``solve_viscous`` bit for bit, and so does the solve
  as it ran before its host part was split off (``_pre_split``), at 1
  lane and at 4 stacked lanes of which one is degenerate (an all-zero
  loop, as the parser benchmark pads a file without one): its NaNs stay
  in its lane.
- ``newton._solve_lanes`` equals the Newton solve composed here from its
  pieces as the port ran it before the programs (``_lane_setup``,
  ``_warm_start``, ``_System``, a round loop of ``reproject_n``,
  ``run_lm`` and ``residual``, the answer), bit for bit, at 1 and 8 lanes,
  with and without a start state.
- Each body reads every tensor of its flat list: seeded noise on any one
  input alone (a flipped flag, a pivot order reversed) moves its output,
  the numbers of a call (alpha, Re, ``n_crit``, the trips) included. A
  number made a tensor inside a body would be frozen into a graph at its
  capture; a tensor read other than from the list would replay the first
  call's data.
- The keys: the direct solve's separates lanes, panels, stations, wake
  stations, passes and relaxation and shares alpha, Re, ``n_crit`` and
  the trip; the set-up's adds ``warm_iters`` and whether a start state is
  given to the LM key.
- The layer's plumbing: ``flatten``/``unflatten`` round trips and refuses
  numbers; a launch inside ``cuda_build.tallied`` is tallied, not
  counted, and ``add_launches`` counts a replay's tally, for any
  kernel's counter (the march's and an LBM kernel's).

The plain march on a CPU costs seconds a call, so every test but one
marches with a stand-in (``_side_stand_in``, ``_wake_stand_in``): cheap,
lane by lane, smooth in every argument, NaN where an input is. The one
test on the plain march holds the direct body to ``solve_viscous`` at 1
lane and 2 passes; ``tests/test_torch_coupled.py``,
``test_torch_lanes.py`` and the Newton tests hold the same code paths on
the plain march to the JAX reference.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from airfoil_tpu_torch import cuda_build
from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.lbm import kernel as lbm_kernel
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.numerics import maximum, minimum
from airfoil_tpu_torch.paneling import panel_geometry, repanel
from airfoil_tpu_torch.viscous import coupled, graphs, kernel, march, newton

N_PANELS, M_S, N_W = 64, 32, 8
DIRECT = {"n_stations": M_S, "n_wake": N_W, "coupling_iters": 6,
          "relax": 0.3}
NOISE_PASSES = 2        # the direct solve's passes in the noise test
WARM, ITERS, ROUNDS = 2, 3, 2
RE = 1e6
_OPS = {}


def _op(code: str):
    if code not in _OPS:
        coords = naca4(int(code[0]), int(code[1]), int(code[2:]), 60)
        _OPS[code] = build_operator(panel_geometry(
            *repanel(coords, N_PANELS, device="cpu")))
    return _OPS[code]


def _chunk():
    """NACA 2412, 0012, an all-zero loop and 4412 as 4 geometry lanes."""
    if "chunk" not in _OPS:
        loops = np.stack([naca4(2, 4, 12, 60), naca4(0, 0, 12, 60),
                          np.zeros((121, 2)), naca4(4, 4, 12, 60)])
        _OPS["chunk"] = build_operator(panel_geometry(*repanel(
            torch.as_tensor(loops.astype(np.float32)), N_PANELS)))
    return _OPS["chunk"]


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _same(a, b) -> bool:
    """Equal bit for bit (NaNs included), leaf by leaf."""
    la, lb = graphs.flatten(a)[0], graphs.flatten(b)[0]
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.float32(v))


def _side_stand_in(s, ue, x, nu, n_crit=9.0, x_forced_transition=1.0):
    """A side march's stand-in: a ``BLState`` smooth in every argument."""
    one, (s2, ue2, x2) = march._as_lanes(s, ue, x)
    nu2, nc2, xt2 = (march._lanes(v, s2)[:, None]
                     for v in (nu, n_crit, x_forced_transition))
    turb = x2 >= xt2
    hk = 2.0 + 0.5 * torch.tanh(10.0 * (xt2 - x2))
    theta = (1e-4 * (1.0 + s2) * (1.0 + 0.1 * ue2) * (1.0 + 1e4 * nu2)
             * (1.0 + 0.01 * nc2))
    bl = march.BLState(
        theta=theta, dstar=hk * theta, hk=hk, cf=1e-3 * ue2 / (1.0 + s2),
        amp=torch.where(turb, torch.nan, nc2 * x2),
        ctau=torch.where(turb, 0.01 + 0.0 * theta, torch.nan),
        turb=turb, separated=hk > 2.4,
        x_transition=torch.minimum(xt2[:, 0], x2[:, -1]))
    return march.BLState(*(a[0] for a in bl)) if one else bl


def _wake_stand_in(s, ue, nu, theta0, dstar0, ctau0):
    """A wake march's stand-in: (theta, dstar, hk) smooth in every
    argument."""
    one, (s2, ue2) = march._as_lanes(s, ue)
    nu2, t0, d0, c0 = (march._lanes(v, s2)[:, None]
                       for v in (nu, theta0, dstar0, ctau0))
    theta = t0 * (1.0 + 0.1 * s2) * ue2 * (1.0 + c0) * (1.0 + 1e3 * nu2)
    hk = 1.0 + (d0 / t0 - 1.0) * torch.exp(-s2)
    out = (theta, hk * theta, hk)
    return tuple(a[0] for a in out) if one else out


@pytest.fixture(autouse=True)
def stand_in_marches(request, monkeypatch):
    """The stand-in marches, but for the test on the plain march."""
    if "plain_march" not in request.node.name:
        monkeypatch.setattr(kernel, "march_side", _side_stand_in)
        monkeypatch.setattr(kernel, "march_wake", _wake_stand_in)


# ── the direct solve ──────────────────────────────────────────────────────

def _pre_split(op, alpha, reynolds, n_crit, trip, shape):
    """``solve_viscous`` as the port ran it before the programs: no host
    part, the whole operator into the solve, alpha and nu made tensors
    there, ``n_crit`` and the trip passed on to the marches as the caller
    gave them (the body after those lines is the same code)."""
    xm = op.pan.xm
    tree = (op, torch.as_tensor(alpha, dtype=xm.dtype, device=xm.device),
            1.0 / torch.as_tensor(reynolds, dtype=xm.dtype, device=xm.device),
            n_crit, trip)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(graphs, "unflatten", lambda _spec, _flat: tree)
        return coupled._direct_body(None, shape["n_stations"],
                                    shape["n_wake"], shape["coupling_iters"],
                                    shape["relax"], [])


def _direct_pair(op, shape):
    """(the direct body on a flat list made here, ``solve_viscous``), and
    the pre-split solve's result held to the latter bit for bit."""
    alpha, n_crit, trip = 3.0, 8.0, 0.6
    want = coupled.solve_viscous(op, alpha, RE, n_crit, trip, **shape)
    assert _same(_pre_split(op, alpha, RE, n_crit, trip, shape), want)
    flat, spec = graphs.flatten((
        coupled._read_fields(op), _f32(alpha), 1.0 / _f32(RE), _f32(n_crit),
        _f32(trip)))
    got = coupled._direct_body(spec, shape["n_stations"], shape["n_wake"],
                               shape["coupling_iters"], shape["relax"], flat)
    return got, want


def test_direct_body_equals_solve_viscous_on_the_plain_march():
    got, want = _direct_pair(_op("2412"), dict(DIRECT, coupling_iters=1))
    assert _same(got, want)
    assert bool(torch.isfinite(want.cl) & torch.isfinite(want.cd))


@pytest.mark.parametrize("lanes", [1, 4])
def test_direct_body_equals_solve_viscous(lanes):
    got, want = _direct_pair(_op("2412") if lanes == 1 else _chunk(),
                             DIRECT)
    assert _same(got, want)
    finite = torch.isfinite(want.cl) & torch.isfinite(want.cd)
    if lanes == 1:
        assert bool(finite)
    else:
        # The degenerate lane is NaN, the others finite and equal to the
        # first lane's one-geometry solve where it is the same section.
        assert finite.tolist() == [True, True, False, True]
        assert torch.isnan(want.cp[2]).all()
        assert torch.isfinite(want.cp[[0, 1, 3]]).all()
        _got, one = _direct_pair(_op("2412"), DIRECT)
        assert _same(tuple(a[0] for a in graphs.flatten(want)[0]),
                     tuple(graphs.flatten(one)[0]))


def _direct_flat(op):
    return graphs.flatten((coupled._read_fields(op), _f32(2.0), 1.0 / _f32(RE),
                           _f32(9.0), _f32(0.3)))


# ── the Newton solve ──────────────────────────────────────────────────────

def _start_states(p: int) -> torch.Tensor:
    """(P, n3) seeded start states (the recipe of ``test_torch_graphs``):
    sides thickening from the stagnation point with Hk 1.4-4 and n rising
    through n_crit, a wake of Hk 1.1-2.5, n = 0."""
    rng = np.random.default_rng(40 + p)

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


def _composed(op, alphas, trip_u, trip_l, zz_init):
    """The Newton solve of ``_solve_lanes`` composed from its pieces as the
    port ran it before its programs: (ViscousResult, fallback scalars,
    final state)."""
    p = alphas.shape[0]
    re = torch.full((p,), RE, dtype=torch.float32)
    n_crit = torch.full((p,), 9.0, dtype=torch.float32)
    nu = 1.0 / re
    lane_op, cl_inv, vt0, wop, grid = newton._lane_setup(op, alphas, M_S, N_W)
    zz0, front_u, front_l, warm_state = newton._warm_start(
        lane_op, wop, grid, vt0, nu, n_crit, trip_u, trip_l, M_S, N_W, WARM)
    x_u = minimum(trip_u, front_u + 0.15 + 0.6 * front_u)
    x_l = minimum(trip_l, front_l + 0.15 + 0.6 * front_l)
    zz_i = zz0 if zz_init is None else zz_init
    system = newton._System(lane_op, wop, grid, vt0, nu, M_S, N_W, n_crit,
                            x_u, x_l, zz_i)
    # The round loop before the programs.
    zz, lam = zz_i, torch.full((p,), 1e-3, dtype=torch.float32)
    best_zz, best_rms = zz_i, torch.full((p,), torch.inf)
    rms_prev = best_rms
    done = torch.zeros(p, dtype=torch.bool)
    for _ in range(ROUNDS):
        act = ~done
        zz_r = system.reproject_n(zz)
        zz_r, lam_r = system.run_lm(zz_r, maximum(lam, 1e-4), ITERS)
        rms_r = newton._rms(system.residual(zz_r))
        ok_r = act & (rms_r < best_rms) & torch.isfinite(zz_r).all(-1)
        best_zz = torch.where(ok_r[:, None], zz_r, best_zz)
        best_rms = torch.where(ok_r, rms_r, best_rms)
        done_r = ((rms_r < newton._RMS_OK)
                  | (rms_r > newton._FUTILITY * rms_prev))
        zz = torch.where(act[:, None], zz_r, zz)
        lam = torch.where(act, lam_r, lam)
        rms_prev = torch.where(act, rms_r, rms_prev)
        done = done | (act & done_r)
        if not bool((~done).any()):
            break
    sc = dict(alpha=alphas, re=re, cl_inv=cl_inv, x_trip=trip_u,
              x_trip_lo=trip_l)
    t = newton._AnswerTensors(
        newton._LaneOps(lane_op.pan, lane_op.due_dsigma), wop, grid, vt0,
        nu, n_crit, x_u, x_l)
    flat, spec = graphs.flatten((t, sc, warm_state, best_zz, best_rms))
    res, fb, xtr = newton._answer_body(spec, M_S, N_W, flat)
    return res, fb, (best_zz, *xtr)


@pytest.mark.parametrize("start", [False, True])
@pytest.mark.parametrize("p", [1, 8])
def test_solve_lanes_equals_its_pieces(p, start):
    alphas = torch.tensor(np.linspace(-2.0, 6.0, p), dtype=torch.float32)
    trip_u = torch.full((p,), 0.3, dtype=torch.float32)
    trip_l = torch.full((p,), 0.4, dtype=torch.float32)
    zz_init = _start_states(p) if start else None
    init = None if zz_init is None else (zz_init, None, None)
    got = newton._solve_lanes(_op("2412"), alphas, RE, 9.0, 0.3, M_S, N_W,
                              WARM, ITERS, ROUNDS, init_state=init,
                              x_trip_lower=0.4)
    want = _composed(_op("2412"), alphas, trip_u, trip_l, zz_init)
    assert _same(got, want)
    assert got[0].cl.shape == (p,)


# ── every input read ──────────────────────────────────────────────────────

def _perturbed(t: torch.Tensor, i: int) -> torch.Tensor:
    """Input ``i`` moved alone: seeded noise of 1 % of its largest value (a
    float), its flags flipped (a bool), its order reversed (the LU's
    pivots), one added (a count)."""
    if t.dtype == torch.bool:
        return ~t
    if t.dtype == torch.int32 and t.dim() and t.shape[-1] > 1:
        return t.flip(-1)
    if not t.is_floating_point():
        return t + 1
    rng = np.random.default_rng(i)
    noise = torch.tensor(rng.standard_normal(tuple(t.shape)).astype(
        np.float32))
    finite = t[torch.isfinite(t)]
    scale = 1e-2 * float(finite.abs().max()) if finite.numel() else 0.0
    return t + (scale + 1e-4) * noise


def _observed(body, flat):
    """``body``'s output and the inputs of every march it made."""
    calls = []
    orig = kernel.march_side, kernel.march_wake

    def side(*args):
        calls.append(args)
        return orig[0](*args)

    def wake(*args):
        calls.append(args)
        return orig[1](*args)

    kernel.march_side, kernel.march_wake = side, wake
    try:
        out = body(flat)
    finally:
        kernel.march_side, kernel.march_wake = orig
    return out, [[a for a in c if isinstance(a, torch.Tensor)]
                 for c in calls]


class _Reads(TorchDispatchMode):
    """Records which of the given tensors' storages an operation reads."""

    def __init__(self, flat):
        super().__init__()
        self.at = {}
        for i, t in enumerate(flat):
            self.at.setdefault(t.untyped_storage().data_ptr(), []).append(i)
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor):
                self.read.update(self.at.get(
                    a.untyped_storage().data_ptr(), ()))
        return func(*args, **kwargs)


def _moves(body, flat, scaled=(), gates=()) -> list:
    """The inputs whose perturbation alone leaves ``body``'s output and the
    inputs of its marches as they were. ``scaled``: {index: factor} for
    inputs perturbed by a factor instead (moved across a threshold).
    ``gates``: inputs that only a saturated gate or a discarded value
    reads, which need only be read by an operation."""
    base = _observed(body, flat)
    with _Reads(flat) as reads:
        body(flat)
    still = []
    for i, t in enumerate(flat):
        if i in gates and i in reads.read:
            continue
        moved = list(flat)
        moved[i] = t * scaled[i] if i in scaled else _perturbed(t, i)
        if _same(_observed(body, moved), base):
            still.append(i)
    return still


def test_direct_body_reads_every_input():
    flat, spec = _direct_flat(_op("2412"))
    body = functools.partial(coupled._direct_body, spec, M_S, N_W,
                             NOISE_PASSES, 0.3)
    assert _moves(body, flat) == []
    # The numbers of the call are the list's last four.
    assert [tuple(t.shape) for t in flat[-4:]] == [()] * 4


def _prepared(p: int, start: bool):
    """The set-up's flat list and body at ``p`` lanes (trips at 0.3 and
    0.4, so that they cut the warm marches)."""
    lanes = lambda v: torch.full((p,), v, dtype=torch.float32)
    alphas = torch.tensor(np.linspace(1.0, 4.0, p), dtype=torch.float32)
    zz_init = _start_states(p) if start else None
    flat, spec = graphs.flatten((
        coupled._read_fields(_op("2412")), alphas, lanes(RE), lanes(9.0),
        lanes(0.3), lanes(0.4), zz_init))
    return flat, functools.partial(newton._prepare_body, spec, M_S, N_W, 1)


@pytest.mark.parametrize("start", [False, True])
def test_prepare_body_reads_every_input(start):
    flat, body = _prepared(1, start)
    # The interaction law is linear in the mass defects but for its source
    # clip, so the start state (the last input) moves its Jacobian only
    # where it drives a source past the clip: its logarithms halved.
    scaled = {len(flat) - 1: 0.5} if start else {}
    assert _moves(body, flat, scaled=scaled) == []


@pytest.fixture(scope="module")
def one_lane():
    """A lane after two rounds: (system, lane values, warm state, state,
    rms)."""
    system, sc, warm_state, zz_i = newton._prepare(
        _op("2412"), 2.0, RE, 9.0, 0.3, M_S, N_W, WARM, x_trip_lower=0.4)
    zz, rms, _rounds = newton._lm_rounds(system, zz_i, 6, 2)
    return system, sc, warm_state, zz, rms


def test_round_bodies_read_every_input(one_lane):
    system, _sc, _ws, zz, _rms = one_lane
    t = system.lm_tensors()._replace(l_mat=None)
    done = torch.zeros(1, dtype=torch.bool)
    rounds = torch.ones(1, dtype=torch.int32)
    lam = torch.full((1,), 1e-3)
    flat, spec = graphs.flatten((zz, lam, done, rounds, t._replace(
        xi_w=None, xt_u=None, xt_l=None, x_trip_u=None, x_trip_l=None)))
    # The re-projection integrates n up to a gate that saturates below
    # n_crit + 2.5: n_crit (the last input) moved by a factor into the
    # profile's range. The interaction law's wake velocities (uw0, wb, ww)
    # are computed and not used: read only.
    names = ["zz", "lam", "done", "rounds",
             *[f for f in newton._LMTensors._fields
               if getattr(t, f) is not None and f not in (
                   "xi_w", "xt_u", "xt_l", "x_trip_u", "x_trip_l")]]
    assert len(names) == len(flat)
    wake = {names.index(f) for f in ("uw0", "wb", "ww")}
    assert _moves(functools.partial(newton._reproject_body, spec, M_S, N_W),
                  flat, scaled={len(flat) - 1: 0.3}, gates=wake) == []
    zz_r = system.lm_step(zz, lam)[0]
    best_rms = torch.full((1,), 10.0)
    # An active lane takes the round's state, a stopped one keeps its
    # carry: every input moves the output of one of the two.
    # n_crit moves the residual's free transition, saturated here: moved by
    # a factor.
    still = []
    for stopped in (done, ~done):
        flat, spec = graphs.flatten((zz_r, lam * 3.0, zz, lam, zz, best_rms,
                                     best_rms, stopped, t))
        n_crit = [i for i, a in enumerate(flat) if a is t.n_crit]
        assert len(n_crit) == 1
        still.append(set(_moves(functools.partial(
            newton._settle_body, spec, M_S, N_W), flat,
            scaled={n_crit[0]: 0.3})))
    assert still[0] & still[1] == set()


def test_answer_body_reads_every_input(one_lane):
    system, sc, warm_state, zz, rms = one_lane
    captured = {}
    orig = graphs.run

    def keep(program, key, body, flat):
        captured["body"], captured["flat"] = body, flat
        return orig(program, key, body, flat)

    graphs.run = keep
    try:
        res, fb, _state = newton._lane_answer(system, sc, warm_state, zz, rms)
    finally:
        graphs.run = orig
    flat = captured["flat"]
    # Read only: the rms (the last input), Re, the inviscid CL and the warm
    # state's settled flag feed only the verdicts' gates, which other gates
    # may hold shut; the oracle march's trip is the smaller of the solved
    # front and the trip; the warm sides' Hk and ctau at the trailing edge
    # set the wake's initial shear stress above its floor only.
    ws = warm_state
    only_read = (rms, sc["re"], sc["cl_inv"], sc["x_trip"], ws["settled"],
                 ws["bl_u"].hk, ws["bl_u"].ctau, ws["bl_l"].hk,
                 ws["bl_l"].ctau)
    gates = {i for i, t in enumerate(flat) if any(t is v for v in only_read)}
    assert flat[-1] is rms and len(gates) == len(only_read)
    assert _moves(captured["body"], flat, gates=gates) == []


# ── the keys ──────────────────────────────────────────────────────────────

class _Keyed(Exception):
    pass


@pytest.fixture
def keys(monkeypatch):
    """Every (program, key) that reaches ``graphs.run``; the call then
    stops."""
    seen = []

    def record(program, key, body, flat):
        seen.append((program, key))
        raise _Keyed

    monkeypatch.setattr(graphs, "run", record)
    return seen


def _key_of(keys, fn, *args, **kwargs):
    with pytest.raises(_Keyed):
        fn(*args, **kwargs)
    return keys[-1]


def test_direct_keys(keys):
    op, kw = _op("2412"), dict(DIRECT)
    key = lambda o=op, **k: _key_of(keys, coupled.solve_viscous, o, 2.0,
                                    RE, **dict(kw, **k))
    base = key()
    assert base[0] == "direct"
    shared = [_key_of(keys, coupled.solve_viscous, op, 5.0, 3e5, 7.0, 0.1,
                      **kw),
              _key_of(keys, coupled.solve_viscous, _op("0012"), 2.0, RE,
                      **kw)]
    assert all(k == base for k in shared)
    other = [key(o=_chunk()), key(o=[_op("2412"), _op("0012")]),
             key(n_stations=24), key(n_wake=6), key(coupling_iters=5),
             key(relax=0.25)]
    coords = naca4(2, 4, 12, 60)
    other.append(key(o=build_operator(panel_geometry(
        *repanel(coords, 48, device="cpu")))))
    assert len({base, *other}) == len(other) + 1


def test_prepare_keys(keys):
    op = _op("2412")

    def key(p=1, warm=WARM, start=False, o=op):
        init = (_start_states(p), None, None) if start else None
        alphas = np.linspace(0.0, 4.0, p).tolist() if p > 1 else 2.0
        return _key_of(keys, newton._prepare, o, alphas, RE, 9.0, 1.0, M_S,
                       N_W, warm, init)

    base = key()
    assert base[0] == "prepare"
    assert _key_of(keys, newton._prepare, op, 7.0, 2e5, 8.0, 0.2, M_S, N_W,
                   WARM, None, 0.5) == base
    assert key(o=_op("0012")) == base
    other = [key(p=8), key(warm=1), key(start=True), key(p=8, o=[op] * 8)]
    assert len({base, *other}) == len(other) + 1


# ── the layer's plumbing ──────────────────────────────────────────────────

def test_flatten_round_trips():
    t = [torch.arange(3.0), torch.ones(2, dtype=torch.bool)]
    tree = (coupled.SideBL(*([t[0]] * 10)), {"b": t[1], "a": None},
            [t[0], (t[1],)])
    flat, spec = graphs.flatten(tree)
    assert len(flat) == 13
    back = graphs.unflatten(spec, flat)
    assert type(back[0]) is coupled.SideBL and list(back[1]) == ["b", "a"]
    assert back[1]["a"] is None and isinstance(back[2], list)
    assert _same(back, tree)
    with pytest.raises(TypeError):
        graphs.flatten((t[0], 1.0))


def test_launches_in_a_capture_are_tallied(monkeypatch):
    class Lib:
        @staticmethod
        def k_launch(*args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(kernel, "march_launches", 0)
    monkeypatch.setattr(kernel, "wake_launches", 0)
    monkeypatch.setattr(lbm_kernel, "tiled_launches", 0)
    side, wake, tiled = ((kernel.__name__, "march_launches"),
                         (kernel.__name__, "wake_launches"),
                         (lbm_kernel.__name__, "tiled_launches"))
    dev = torch.device("cuda", 0)
    launch = functools.partial(cuda_build.launch, Lib, "k_launch", [], dev)
    launch(side)
    with cuda_build.tallied() as tally:
        launch(side)
        launch(side)
        launch(wake)
        launch(tiled)
    assert tally == {side: 2, wake: 1, tiled: 1}
    counts = lambda: (kernel.march_launches, kernel.wake_launches,
                      lbm_kernel.tiled_launches)
    assert counts() == (1, 0, 0)
    cuda_build.add_launches(tally, 3)
    assert counts() == (7, 3, 3)
