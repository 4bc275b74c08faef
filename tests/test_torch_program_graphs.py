"""The operator build, the standalone inviscid solve and the frame
diagnostics as programs of the compiled-program layer (``viscous.graphs``)
on the CPU, where their bodies run eagerly: ``inviscid.programs``
(``"operator"``, ``"inviscid"``) and ``lbm.diagnostics.frame_fields``
(``"frame"``).

- Each body, called here on a flat list made here, equals the function it
  replaces bit for bit: the operator's two graphs around the eager factor
  equal ``build_operator(panel_geometry(*repanel(...)))`` (smoothed, and
  over lanes with an all-zero loop, too), the inviscid body
  ``solve_inviscid`` (one angle, 8 angles, with sources, over lanes), the
  frame body with ``u0`` a 0-dim tensor ``forces_and_separation`` and
  ``render_fields`` with the float ``u0``.
- Each body reads every tensor of its flat list: seeded noise on any one
  input alone (the coordinates, ``u0``, the mask, alpha, sigma, the
  lattice, each operator field, the pivots reversed) moves its output.
- Against the JAX reference on the same numpy inputs: the operator at the
  polar's padded 192-point bucket against ``_op_kernel`` and
  ``_op_kernel_smoothed``, and over 4 lanes against the vmapped build, at
  ``tests/test_torch_inviscid.py``'s bars (rtol 1e-5, atol 1e-5 of each
  field's largest magnitude): the repaneled nodes against the reference
  program's, the operator against the reference's build on the program's
  own nodes (the nodes differ by an ulp or two, which the sharp trailing
  edge's shortest panels amplify past the bar), the lanes' solved
  ``dgamma_dsigma`` by backward error as the inviscid tests hold the
  cusped section's; the inviscid program over 8 angles against
  the vmapped ``solve_inviscid`` at the same bars; the frame at 384x192
  after 200 steps against ``forces_and_separation`` and ``render_fields``
  at ``tests/test_torch_lbm.py::TestDiagnostics``'s bars (CL and CD
  within 4 float32 ulps of the summed face pressures, the separation
  share within 2 faces, the fields at rtol 1e-5 / atol 1e-6 on fluid
  cells, NaN exactly on solid cells).
- The wiring: a recording stub of ``graphs.run`` sees the polar's
  operator builds (plain and smoothed), the parser benchmark's chunk, the
  batch's lanes (one loop a key), the graft entry's build, the walk's
  fill (single-device and sharded), strategy 3, the flow field's solve and
  the tunnel's frame reach their programs at their keys; and the
  upload's, the flow field's and the probe's operator builds, and the
  inviscid solves inside the direct solve and the Newton set-up, reach
  none.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.config import LBMConfig
from airfoil_tpu.inviscid import build_operator as jbuild
from airfoil_tpu.inviscid import solve_inviscid as jsolve
from airfoil_tpu.lbm import core as jcore
from airfoil_tpu.lbm import diagnostics as jdiag
from airfoil_tpu.models import naca4 as ref_naca4
from airfoil_tpu.paneling import panel_geometry as jgeom
from airfoil_tpu.paneling import repanel as jrepanel
from airfoil_tpu.paneling import smooth_geometry as jsmooth
from airfoil_tpu.polar import sweep as jsweep
from airfoil_tpu_torch import graft_entry
from airfoil_tpu_torch import viscous as viscous_pkg
from airfoil_tpu_torch.bench import paneling_probe
from airfoil_tpu_torch.bench import parser_benchmark as pb
from airfoil_tpu_torch.inviscid import (build_operator, flowfield, programs,
                                        solve_inviscid)
from airfoil_tpu_torch.inviscid.panel_solver import factor
from airfoil_tpu_torch.lbm import diagnostics
from airfoil_tpu_torch.lbm.runner import WindTunnel
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.paneling import panel_geometry, repanel, smooth_geometry
from airfoil_tpu_torch.parallel import mesh as PM
from airfoil_tpu_torch.polar import analyze, batch, sweep
from airfoil_tpu_torch.viscous import coupled, graphs, kernel, newton
from test_torch_lbm import _force_bar, _mask, _noisy_f, _surface_faces
from test_torch_solver_graphs import (_perturbed, _same, _side_stand_in,
                                      _wake_stand_in)
from torch_parity import compare

N_PANELS = 64
ASSEMBLED = ["a_full", "bn", "at_full", "bt", "at_a", "at_b", "rhs_scale"]
SOLVED = ["due_dsigma", "dgamma_dsigma"]
PANELING = ["xp", "yp", "xm", "ym", "tx", "ty", "nx", "ny", "length", "s"]
ANGLES = np.linspace(-4.0, 10.0, 8, dtype=np.float32)
U0S = (0.06, 0.048, 0.1 / 3.0)


def _loop(m=2, p=4, t=12, n=60) -> torch.Tensor:
    return torch.as_tensor(np.asarray(naca4(m, p, t, n), np.float32))


def _lanes() -> torch.Tensor:
    """NACA 2412, 0012, an all-zero loop and 4412 as 4 loops of 121
    points."""
    return torch.as_tensor(np.stack([
        naca4(2, 4, 12, 60), naca4(0, 0, 12, 60), np.zeros((121, 2)),
        naca4(4, 4, 12, 60)]).astype(np.float32))


COORDS = {"one loop": (_loop, False), "smoothed": (_loop, True),
          "4 lanes": (_lanes, False)}


def _built(coords, smooth):
    """The build the program replaces: repanel, smoothing, paneling,
    ``build_operator``."""
    xp, yp = repanel(coords, N_PANELS)
    xs, ys = smooth_geometry(xp, yp) if smooth else (xp, yp)
    return build_operator(panel_geometry(xs, ys)), xp, yp


def _operator_from_bodies(coords, smooth):
    """The operator program's two bodies around the eager factor, called
    on flat lists made here."""
    op, xp, yp = programs._influence_body(N_PANELS, smooth, [coords])
    lu, piv = factor(op.a_full)
    ginf, due = programs._sensitivity_body(
        [op.a_full, lu, piv, op.bn, op.at_full, op.bt])
    return (op._replace(lu=lu, piv=piv, due_dsigma=due, dgamma_dsigma=ginf),
            xp, yp)


# ── bodies unchanged ──────────────────────────────────────────────────────

@pytest.mark.parametrize("case", list(COORDS))
def test_operator_body_is_the_build(case):
    make, smooth = COORDS[case]
    coords = make()
    want = _built(coords, smooth)
    assert _same(_operator_from_bodies(coords, smooth), want)
    assert _same(programs.operator_program(coords, N_PANELS, smooth), want)


def test_operator_lane_not_finite_stays_in_its_lane():
    op, _xp, _yp = programs.operator_program(_lanes(), N_PANELS)
    bad = [bool((~torch.isfinite(t.reshape(4, -1))).any())
           for t in graphs.flatten(op)[0] if t.is_floating_point()]
    assert any(bad)
    lanes = torch.zeros(4, dtype=torch.bool)
    for t in graphs.flatten(op)[0]:
        if t.is_floating_point():
            lanes |= ~torch.isfinite(t.reshape(4, -1)).all(-1)
    assert lanes.tolist() == [False, False, True, False]


def test_operator_smoothing_takes_one_loop():
    with pytest.raises(ValueError):
        programs.operator_program(_lanes(), N_PANELS, smooth=True)


def _op(lanes=False):
    return _built(_lanes() if lanes else _loop(), False)[0]


SOLVES = {"one angle": (False, 3.0, False),
          "8 angles": (False, torch.as_tensor(ANGLES), False),
          "sources": (False, 3.0, True),
          "lanes": (True, 3.0, False)}


def _solve_args(case):
    lanes, alpha, with_sigma = SOLVES[case]
    op = _op(lanes)
    sigma = None
    if with_sigma:
        rng = np.random.default_rng(7)
        sigma = torch.as_tensor((1e-3 * rng.standard_normal(N_PANELS))
                                .astype(np.float32))
    return op, alpha, sigma


def _inviscid_flat(op, alpha, sigma):
    """The inviscid program's flat list and structure, made here."""
    read = op._replace(pan=op.pan._replace(xp=None, yp=None, s=None),
                       at_a=None, at_b=None, due_dsigma=None,
                       dgamma_dsigma=None)
    if sigma is None:
        read = read._replace(bn=None, bt=None)
    return graphs.flatten((read, graphs.as_input(alpha, op.pan.xm), sigma))


@pytest.mark.parametrize("case", list(SOLVES))
def test_inviscid_body_is_solve_inviscid(case):
    op, alpha, sigma = _solve_args(case)
    want = solve_inviscid(op, alpha, sigma)
    flat, spec = _inviscid_flat(op, alpha, sigma)
    assert _same(programs._inviscid_body(spec, flat), want)
    assert _same(programs.inviscid_program(op, alpha, sigma), want)


def _lattice(cfg, steps=0, alpha=6.0, seed=0):
    """(f, solid) as numpy: the seeded noisy freestream, ``steps`` JAX
    steps later."""
    solid = _mask(cfg, alpha)
    f = _noisy_f(cfg, seed)
    if steps:
        f = np.asarray(jcore.lbm_step(jnp.asarray(f), jnp.asarray(solid),
                                      cfg.u0, cfg.tau, steps=steps))
    return f, solid


def _diagnostics(f, solid, u0, chord_cells):
    return (*diagnostics.forces_and_separation(f, solid, u0, chord_cells),
            *diagnostics.render_fields(f, solid, u0))


@pytest.mark.parametrize("u0", U0S)
def test_frame_body_is_the_diagnostics(u0):
    cfg = LBMConfig(nx=96, ny=48)
    f, solid = (torch.as_tensor(a) for a in _lattice(cfg, seed=3))
    want = _diagnostics(f, solid, u0, cfg.chord_cells)
    u0_t = torch.tensor(np.float32(u0))
    assert _same(diagnostics._frame_body(cfg.chord_cells, [f, solid, u0_t]),
                 want)
    assert _same(diagnostics.frame_fields(f, solid, u0, cfg.chord_cells),
                 want)


# ── every input read ──────────────────────────────────────────────────────

def _moved(body, flat, i):
    """Whether input ``i`` moved alone moves ``body``'s output."""
    base = body(flat)
    moved = list(flat)
    moved[i] = _perturbed(flat[i], i)
    return not _same(body(moved), base)


def _sensitivity_flat():
    op, _xp, _yp = programs._influence_body(N_PANELS, False, [_loop()])
    lu, piv = factor(op.a_full)
    return [op.a_full, lu, piv, op.bn, op.at_full, op.bt]


@pytest.mark.parametrize("smooth", [False, True])
def test_operator_reads_its_coordinates(smooth):
    body = functools.partial(programs._influence_body, N_PANELS, smooth)
    assert _moved(body, [_loop()], 0)


@pytest.mark.parametrize("i", range(6))
def test_operator_sensitivities_read_every_input(i):
    assert _moved(programs._sensitivity_body, _sensitivity_flat(), i)


@pytest.mark.parametrize("case", ["8 angles", "sources"])
def test_inviscid_reads_every_input(case):
    op, alpha, sigma = _solve_args(case)
    flat, spec = _inviscid_flat(op, alpha, sigma)
    body = functools.partial(programs._inviscid_body, spec)
    unread = [i for i in range(len(flat)) if not _moved(body, flat, i)]
    assert unread == []


@pytest.mark.parametrize("i, name", [(0, "f"), (1, "solid"), (2, "u0")])
def test_frame_reads_every_input(i, name):
    cfg = LBMConfig(nx=96, ny=48)
    f, solid = (torch.as_tensor(a) for a in _lattice(cfg, seed=3))
    flat = [f, solid, torch.tensor(np.float32(cfg.u0))]
    if name == "solid":      # a mask moved: a flipped cell
        moved = solid.clone()
        moved[20, 30] = 1.0 - moved[20, 30]
        body = functools.partial(diagnostics._frame_body, cfg.chord_cells)
        assert not _same(body([f, moved, flat[2]]), body(flat))
    else:
        assert _moved(functools.partial(diagnostics._frame_body,
                                        cfg.chord_cells), flat, i)


# ── against the JAX reference ─────────────────────────────────────────────

def _fields(op, names):
    return {k: getattr(op, k) for k in names}


def _compare_operator(port, ref):
    """The operator's fields but the factor (LAPACK's pivots are not
    JAX's), and its paneling's, at the inviscid tests' bars."""
    compare(_fields(port, ASSEMBLED + SOLVED), _fields(ref, ASSEMBLED + SOLVED),
            rtol=1e-5, atol_scale=1e-5)
    compare(_fields(port.pan, PANELING), _fields(ref.pan, PANELING),
            rtol=1e-5, atol_scale=1e-5)


def _nodes_held(port_nodes, ref_nodes):
    """The program's repaneled nodes against the reference program's, at
    the same bars: they differ by an ulp or two (float32 arc lengths summed
    in another order)."""
    compare([a.numpy() for a in port_nodes], [np.asarray(a) for a in ref_nodes],
            rtol=1e-5, atol_scale=1e-5)


@pytest.mark.parametrize("smooth", [False, True])
def test_operator_at_the_polar_bucket_against_jax(smooth):
    """``_op_kernel`` (``_op_kernel_smoothed``) of NACA 2412 padded to 192
    points, 160 panels: the nodes against the reference program's, the
    operator against the reference's build (smoothing included) on the
    program's own nodes. (On their own nodes the sharp trailing edge's
    shortest panels turn those ulps into up to 4e-5 of ``a_full``'s unit
    entries, 4 times the bar, at 9 of its 25,921 entries.)"""
    coords = np.asarray(ref_naca4(2, 4, 12, 80), np.float32)   # 161 points
    padded = np.asarray(jsweep._pad_coords(jnp.asarray(coords)))
    assert padded.shape == (192, 2)
    c = sweep._pad_coords(torch.as_tensor(coords))
    _op, xp, yp = sweep._op_kernel(c, 160)
    _ref_op, rxp, ryp = jsweep._op_kernel(jnp.asarray(padded), 160)
    _nodes_held((xp, yp), (rxp, ryp))
    got = sweep._op_kernel_smoothed(c, 160) if smooth else _op
    nodes = (jnp.asarray(xp.numpy()), jnp.asarray(yp.numpy()))
    if smooth:
        nodes = jsmooth(*nodes)
        _nodes_held((got.pan.xp, got.pan.yp),
                    (jsweep._op_kernel_smoothed(jnp.asarray(padded),
                                                160).pan.xp,
                     jsweep._op_kernel_smoothed(jnp.asarray(padded),
                                                160).pan.yp))
    _compare_operator(got, jbuild(jgeom(*nodes)))


def test_operator_lanes_against_jax_vmap():
    """4 loops as lanes: the nodes against the vmapped reference repanel,
    the operator against the vmapped reference build on the program's own
    nodes. ``dgamma_dsigma``, the solve through two float32 LU factors of
    different libraries, sits at the bar's edge (0.5 to 1.4 times it at 64
    to 160 panels on these loops), so it is held as the inviscid tests hold
    the cusped section's: a normwise backward error (per column,
    |A g - b| / (|A| |g| + |b|) in the max norm) below 1e-6 in the
    reference's own system, lane by lane; every other field at the bars."""
    loops = np.stack([ref_naca4(m, 4, t, 60) for m, t in
                      ((2, 12), (0, 9), (4, 15), (2, 18))]).astype(np.float32)
    got, xp, yp = programs.operator_program(torch.as_tensor(loops), N_PANELS)
    _nodes_held((xp, yp), jax.vmap(lambda c: jrepanel(c, N_PANELS))(
        jnp.asarray(loops)))
    want = jax.vmap(lambda x, y: jbuild(jgeom(x, y)))(
        jnp.asarray(xp.numpy()), jnp.asarray(yp.numpy()))
    fields = ASSEMBLED + ["due_dsigma"]
    compare(_fields(got, fields), _fields(want, fields), rtol=1e-5,
            atol_scale=1e-5)
    compare(_fields(got.pan, PANELING), _fields(want.pan, PANELING),
            rtol=1e-5, atol_scale=1e-5)
    for lane in range(len(loops)):
        a = np.asarray(want.a_full[lane], np.float64)
        rhs = np.concatenate([-np.asarray(want.bn[lane]),
                              np.zeros((1, N_PANELS))], 0)
        g = got.dgamma_dsigma[lane].numpy().astype(np.float64)
        resid = np.abs(a @ g - rhs).max(axis=0)
        scale = (np.abs(a).sum(axis=1).max() * np.abs(g).max(axis=0)
                 + np.abs(rhs).max(axis=0))
        assert (resid / scale).max() < 1e-6, (lane, (resid / scale).max())


def test_inviscid_angles_against_jax_vmap():
    coords = np.asarray(ref_naca4(2, 4, 12, 80), np.float32)
    xp, yp = (np.array(a) for a in jrepanel(coords, 160))
    ref_op = jbuild(jgeom(xp, yp))
    op = build_operator(panel_geometry(torch.as_tensor(xp),
                                       torch.as_tensor(yp)))
    got = programs.inviscid_program(op, torch.as_tensor(ANGLES))
    want = jax.vmap(lambda a: jsolve(ref_op, a))(jnp.asarray(ANGLES))
    compare(got, want, rtol=1e-5, atol_scale=1e-5,
            fields=["gamma", "vt", "cp"])
    np.testing.assert_allclose(got.cl.numpy(), np.asarray(want.cl), atol=1e-5)
    np.testing.assert_allclose(got.cm.numpy(), np.asarray(want.cm), atol=1e-5)


def test_frame_against_jax_after_200_steps():
    cfg = LBMConfig()
    f, solid = _lattice(cfg, steps=200)
    got = diagnostics.frame_fields(torch.tensor(f), torch.tensor(solid),
                                   cfg.u0, cfg.chord_cells)
    ref = (*jdiag.forces_and_separation(jnp.asarray(f), jnp.asarray(solid),
                                        cfg.u0, cfg.chord_cells),
           *jdiag.render_fields(jnp.asarray(f), jnp.asarray(solid), cfg.u0))
    bar = _force_bar(f, solid, cfg)
    assert abs(float(got[0]) - float(ref[0])) <= bar      # CL
    assert abs(float(got[1]) - float(ref[1])) <= bar      # CD
    assert abs(float(got[2]) - float(ref[2])) * _surface_faces(solid) <= 2.0
    for p, r in zip(got[3:], ref[3:]):
        p, r = p.numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isnan(p), solid > 0.5)
        np.testing.assert_array_equal(np.isnan(r), solid > 0.5)
        fluid = solid <= 0.5
        np.testing.assert_allclose(p[fluid], r[fluid], rtol=1e-5, atol=1e-6)


# ── the wiring ────────────────────────────────────────────────────────────

@pytest.fixture
def programs_seen(monkeypatch):
    """Every (program, key) that reaches ``graphs.run``; the bodies run
    eagerly, the marches are stand-ins."""
    seen = []

    def record(program, key, body, flat):
        seen.append((program, key))
        return body(flat)

    monkeypatch.setattr(graphs, "run", record)
    monkeypatch.setattr(graphs, "run_lm", lambda key, body, flat, iters:
                        (flat[0], flat[1]))
    monkeypatch.setattr(kernel, "march_side", _side_stand_in)
    monkeypatch.setattr(kernel, "march_wake", _wake_stand_in)
    return seen


def _operator_keys(shape, n_panels, smooth=False):
    key = (torch.device("cpu"), shape, n_panels, smooth)
    return [("operator", (*key, "influence")),
            ("operator", (*key, "sensitivities"))]


def _inviscid_key(n_panels, angles, lanes=(), sigma=False):
    return ("inviscid", (torch.device("cpu"), lanes, n_panels, angles, sigma))


def test_polar_operators_reach_the_program(programs_seen):
    coords = sweep._pad_coords(_loop(n=80))
    sweep._op_kernel(coords, 96)
    sweep._op_kernel_smoothed(coords, 96)
    assert programs_seen == (_operator_keys((192,), 96)
                             + _operator_keys((192,), 96, smooth=True))


def test_parser_chunk_reaches_the_program(programs_seen):
    pb.chunk_operators(_lanes().numpy(), "cpu")
    assert programs_seen == _operator_keys((4, 121), pb.N_PANELS)


def test_batch_lanes_reach_one_loop_keys(programs_seen):
    batch._batch_ops([naca4(2, 4, 12, 40), naca4(0, 0, 12, 40)], 64,
                     torch.device("cpu"))
    assert programs_seen == 2 * _operator_keys((81,), 64)


def test_graft_entry_reaches_the_program(programs_seen, monkeypatch):
    z = torch.zeros(())
    monkeypatch.setattr(viscous_pkg, "solve_viscous", lambda *a, **kw:
                        SimpleNamespace(cl=z, cd=z, cm=z))
    fn, args = graft_entry.entry("cpu")
    fn(*args)
    assert programs_seen == _operator_keys((121,), 128)


def test_walk_fill_reaches_the_program(programs_seen, monkeypatch):
    p = 8
    alphas = torch.linspace(-2.0, 12.0, p)

    def walk(op, a_seq, *rest):
        z = torch.zeros(2 * p)
        return (z,) * 4 + (z > 0,) + (z,) * 3, z > 0

    monkeypatch.setattr(sweep, "_walk", walk)
    monkeypatch.setattr(PM, "_walk", walk)
    op = _op()
    m1 = (torch.zeros(p),) * 4 + (torch.ones(p, dtype=torch.bool),) + \
        (torch.zeros(p),) * 3
    st1 = (torch.zeros(p, 3), torch.zeros(p), torch.zeros(p))
    nok1 = torch.zeros(p, dtype=torch.bool)
    sweep._walk_kernel(op, alphas, torch.full((p,), 1e6), m1, nok1, st1)
    PM._local_walk(op, alphas, torch.full((p,), 1e6), m1, nok1, st1)
    assert programs_seen == 2 * [_inviscid_key(N_PANELS, (p,))]


def test_strategy_3_reaches_the_program_and_the_upload_build_does_not(
        programs_seen, monkeypatch):
    no = torch.tensor(False)
    monkeypatch.setattr(analyze, "solve_viscous_newton",
                        lambda *a, **kw: SimpleNamespace(converged=no))
    monkeypatch.setattr(analyze, "solve_polar_point",
                        lambda *a, **kw: (None, (no, None)))
    monkeypatch.setattr(analyze, "solve_viscous",
                        lambda *a, **kw: SimpleNamespace(converged=no))
    res = analyze.analyze_airfoil(naca4(2, 4, 12, 40), reynolds=1e6,
                                  alpha=7.0, n_panels=N_PANELS, device="cpu")
    assert res.strategy == 3
    assert programs_seen == [_inviscid_key(N_PANELS, ())]


def test_flow_field_solve_reaches_the_program_and_its_build_does_not(
        programs_seen):
    flowfield.compute_flow_field(naca4(2, 4, 12, 40), 4.0, n_streamlines=2,
                                 grid_res=12, n_panels=N_PANELS,
                                 device="cpu")
    assert programs_seen == [_inviscid_key(N_PANELS, ())]


def test_probe_build_stays_eager(programs_seen, monkeypatch):
    monkeypatch.setattr(paneling_probe, "solve_viscous",
                        lambda *a, **kw: None)
    for plan in paneling_probe.PLANS.values():
        paneling_probe._solve_with(naca4(2, 4, 12, 40), 5.0, 1e6,
                                   device="cpu", **{"n_panels": N_PANELS,
                                                    **plan})
    assert programs_seen == []


def test_solves_inside_captured_bodies_stay_inside(programs_seen):
    op = _op()
    coupled.solve_viscous(op, 3.0, 1e6, n_stations=16, n_wake=4,
                          coupling_iters=1)
    newton.solve_viscous_newton(op, 3.0, 1e6, n_stations=16, n_wake=4,
                                warm_iters=1)
    assert {p for p, _k in programs_seen} <= {
        "direct", "prepare", "reproject", "settle", "answer"}
    assert programs_seen[0][0] == "direct"


def test_tunnel_frame_reaches_the_program(programs_seen):
    cfg = LBMConfig(nx=64, ny=32)
    wt = WindTunnel(naca4(2, 4, 12, 40), cfg=cfg, device="cpu")
    wt.frame(steps=2)
    wt.set_u0(0.05)
    wt.set_alpha(9.0)
    out = wt.frame(steps=2)
    key = ("frame", (torch.device("cpu"), (32, 64), cfg.chord_cells))
    assert programs_seen == [key, key]
    assert set(out["fields"]) == {"speed", "cp", "vorticity", "ux", "uy"}
