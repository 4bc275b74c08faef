"""The port's compiled-program layer around the LM graphs, on the CPU:
``utils/compile_cache.py``, ``polar.sweep.warm_polar_kernels``,
``api.handlers.start_warmup``, ``minihttp.serve``'s call of it, and the
headline bench's warm-up, each against what the reference does.

- ``host_fingerprint`` equals the reference's on this host;
  ``enable_persistent_compile_cache`` builds every kernel library (the
  loaders recorded), with or without ``per_host``, and a failed build is
  logged, not raised (as the reference's failure is).
- ``warm_polar_kernels`` has the reference's parameters and defaults
  (and ``device``), and solves at the bucket's shapes: the per-point pass
  over the bucket's lanes (alphas -10..20, Re 1e6, on ``n_coords`` padded
  coordinates), the walk's inviscid fill over them, one continuation
  solve from the pass's first lane, the smoothed rescue over min(8,
  bucket) lanes (none with ``rescue=False``), and the operator (smoothed
  too, but with ``rescue=False``) at the other coordinate buckets.
- ``start_warmup`` starts a daemon thread named ``solver-warmup`` that
  runs the four stages in order (monkeypatched) on the given device, and
  logs a failing stage without raising.
- The programs of ``viscous.graphs`` (the direct solve, the Newton
  set-up, round and answer, the LM iteration, the operator build, the
  inviscid solve): ``warm_polar_kernels`` calls each Newton program at the
  keys of the bucket's pass, walk and rescue, the operator at every
  coordinate bucket and the walk's fill at the bucket, and a polar of that
  bucket afterwards reaches no other key;
  ``analyze.warm_direct_solve`` (``start_warmup``'s last stage) calls the
  direct solve at the key of the analysis's last resort. The marches are
  stand-ins and the LM iterations leave the state as it is: the keys
  depend on shapes alone.
- ``minihttp.serve`` starts the warm-up on its device before it serves
  (``serve_forever`` stubbed).
- ``bench_polar`` calls ``warm_polar_kernels`` (the 32 bucket; the point
  count when reduced) before its warm polar, and splits
  ``warmup_seconds`` into the two.
"""

import inspect
import logging
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from airfoil_tpu.polar import sweep as ref_sweep
from airfoil_tpu.utils import compile_cache as ref_cc
from airfoil_tpu_torch.api import handlers, minihttp
from airfoil_tpu_torch.bench import headline
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.polar import analyze, sweep
from airfoil_tpu_torch.utils import compile_cache
from airfoil_tpu_torch.viscous import graphs, march
from airfoil_tpu_torch.viscous import kernel as march_kernel


def test_host_fingerprint_is_the_reference():
    assert compile_cache.host_fingerprint() == ref_cc.host_fingerprint()


def test_compile_cache_signature():
    assert inspect.signature(
        compile_cache.enable_persistent_compile_cache) == inspect.signature(
        ref_cc.enable_persistent_compile_cache)


@pytest.mark.parametrize("per_host", [False, True])
def test_compile_cache_builds_every_library(monkeypatch, per_host):
    built = []
    monkeypatch.setattr(compile_cache, "_loaders", lambda: {
        name: (lambda n=name: built.append(n))
        for name in ("lbm_steps", "lbm_steps_tiled", "bl_march")})
    compile_cache.enable_persistent_compile_cache(per_host=per_host)
    assert sorted(built) == ["bl_march", "lbm_steps", "lbm_steps_tiled"]


def test_compile_cache_loaders_are_the_kernel_libraries():
    from airfoil_tpu_torch.lbm import kernel as lbm_kernel
    from airfoil_tpu_torch.viscous import kernel as march_kernel

    assert compile_cache._loaders() == {
        "lbm_steps": lbm_kernel.load, "lbm_steps_tiled": lbm_kernel.load_tiled,
        "bl_march": march_kernel.load}


def test_compile_cache_failure_is_logged(monkeypatch, caplog):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(compile_cache, "_loaders",
                        lambda: {"bl_march": broken})
    with caplog.at_level(logging.WARNING, compile_cache.__name__):
        compile_cache.enable_persistent_compile_cache()
    assert "nvcc failed" in caplog.text


def test_warm_polar_kernels_signature():
    ref = inspect.signature(ref_sweep.warm_polar_kernels).parameters
    port = inspect.signature(sweep.warm_polar_kernels).parameters
    assert [(k, v.default) for k, v in ref.items()] == \
        [(k, v.default) for k, v in port.items()][:len(ref)]
    assert list(port)[len(ref):] == ["device"]


@pytest.fixture
def recorded_passes(monkeypatch):
    """The sweep's solves replaced by recorders of their lanes."""
    calls = []

    def op_kernel(coords, n_panels=160):
        calls.append(("op", tuple(coords.shape), n_panels))
        return "op", None, None

    def op_kernel_smoothed(coords, n_panels=160):
        calls.append(("op_s", tuple(coords.shape), n_panels))
        return "op_s"

    def fill(op, alphas):
        calls.append(("fill", op, alphas.tolist()))

    def points(op, alphas, reynolds):
        calls.append(("points", alphas.tolist(), reynolds.tolist()))
        p = alphas.shape[0]
        st = (torch.arange(p * 3.0).reshape(p, 3), torch.arange(p * 1.0),
              torch.arange(p * 1.0) + 0.5)
        return None, (None, st)

    def cont(op, alpha, re, zz, xtr_u, xtr_l, n_stations=96):
        calls.append(("cont", float(alpha), float(re), zz.tolist(),
                      float(xtr_u), float(xtr_l), n_stations))

    def rescue(op_s, a_b, re_b):
        calls.append(("rescue", op_s, a_b.tolist(), re_b.tolist()))

    monkeypatch.setattr(sweep, "_op_kernel", op_kernel)
    monkeypatch.setattr(sweep, "_op_kernel_smoothed", op_kernel_smoothed)
    monkeypatch.setattr(sweep, "inviscid_program", fill)
    monkeypatch.setattr(sweep, "_points_kernel", points)
    monkeypatch.setattr(sweep, "solve_polar_point_cont", cont)
    monkeypatch.setattr(sweep, "_rescue_kernel", rescue)
    return calls


@pytest.mark.parametrize("p, bucket", [(32, 32), (11, 16), (5, 8)])
def test_warm_polar_kernels_solves_the_bucket(recorded_passes, p, bucket):
    sweep.warm_polar_kernels(p=p, device="cpu")
    op, points, fill, cont, op_s, rescue, *others = recorded_passes
    assert op == ("op", (192, 2), 160)
    want = np.linspace(-10.0, 20.0, bucket, dtype=np.float32)
    np.testing.assert_array_equal(points[1], want)
    assert points[2] == [1e6] * bucket
    assert fill[:2] == ("fill", "op")
    np.testing.assert_array_equal(fill[2], want)
    assert cont == ("cont", -10.0, 1e6, [0.0, 1.0, 2.0], 0.0, 0.5,
                    sweep._N_STATIONS)
    assert op_s == ("op_s", (192, 2), 160)
    r = min(8, bucket)
    assert rescue[:2] == ("rescue", "op_s")
    np.testing.assert_array_equal(rescue[2], want[:r])
    assert rescue[3] == [1e6] * r
    # The operator's other coordinate buckets, plain and smoothed.
    assert others == [("op", (128, 2), 160), ("op_s", (128, 2), 160),
                      ("op", (256, 2), 160), ("op_s", (256, 2), 160)]


def test_warm_polar_kernels_without_rescue(recorded_passes):
    sweep.warm_polar_kernels(p=8, n_coords=128, n_panels=96, rescue=False,
                             device="cpu")
    assert [c[0] for c in recorded_passes] == ["op", "points", "fill",
                                               "cont", "op", "op"]
    assert [c[1:] for c in recorded_passes if c[0] == "op"] == [
        ((128, 2), 96), ((192, 2), 96), ((256, 2), 96)]


@pytest.fixture
def stages(monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache, "enable_persistent_compile_cache",
                        lambda: calls.append(("cache",)))
    monkeypatch.setattr(sweep, "warm_polar_kernels",
                        lambda **kw: calls.append(("polar", kw)))

    def analyze_airfoil(coords, reynolds, alpha, device=None):
        calls.append(("analyze", np.asarray(coords).tolist(), reynolds,
                      alpha, device))

    monkeypatch.setattr(analyze, "analyze_airfoil", analyze_airfoil)
    monkeypatch.setattr(analyze, "warm_direct_solve",
                        lambda **kw: calls.append(("direct", kw)))
    return calls


def test_start_warmup_runs_the_stages_in_order(stages):
    t = handlers.start_warmup("cpu")
    assert isinstance(t, threading.Thread)
    assert t.name == "solver-warmup" and t.daemon
    t.join(timeout=60)
    assert not t.is_alive()
    assert [c[0] for c in stages] == ["cache", "polar", "analyze", "direct"]
    assert stages[1][1] == {"p": 32, "device": "cpu"}
    assert stages[2][1:] == (naca4(2, 4, 12, 60).tolist(), 1e6, 14.0, "cpu")
    assert stages[3][1] == {"device": "cpu"}


def test_start_warmup_logs_a_failure(stages, monkeypatch, caplog):
    def broken(**kw):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(sweep, "warm_polar_kernels", broken)
    with caplog.at_level(logging.INFO, handlers.__name__):
        t = handlers.start_warmup("cpu")
        t.join(timeout=60)
    assert not t.is_alive()
    assert [c[0] for c in stages] == ["cache"]
    assert "solver warmup failed" in caplog.text
    assert "capture failed" in caplog.text


def test_serve_starts_the_warmup(monkeypatch):
    calls = []

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            calls.append("serve_forever")

    def make_server(host, port, device=None):
        calls.append(("make_server", str(device)))
        return Server()

    monkeypatch.setattr(minihttp, "make_server", make_server)
    monkeypatch.setattr(handlers, "start_warmup",
                        lambda device=None: calls.append(("warmup",
                                                          str(device))))
    minihttp.serve(port=0, device="cpu")
    assert calls == [("make_server", "cpu"), ("warmup", "cpu"),
                     "serve_forever"]


@pytest.mark.parametrize("reduced", [True, False])
def test_bench_polar_warms_before_its_warm_polar(monkeypatch, reduced):
    calls = []
    monkeypatch.setattr(sweep, "warm_polar_kernels",
                        lambda **kw: calls.append(("warm", kw)))

    def solve_polar(coords, alphas, reynolds, n_panels=160, device=None):
        calls.append(("polar", len(alphas)))
        p = len(alphas)
        z = np.zeros(p, np.float32)
        return sweep.PolarResult(np.asarray(alphas), z + reynolds, z, z, z,
                                 z, np.zeros(p, int), z == 0, z, z, z)

    monkeypatch.setattr(sweep, "solve_polar", solve_polar)
    got = headline.bench_polar(reduced=reduced, reps=1, device="cpu")
    n = 11 if reduced else 31
    assert calls == [("warm", {"p": n if reduced else 32,
                               "device": torch.device("cpu")}),
                     ("polar", n), ("polar", n)]
    assert set(got["warmup_seconds"]) == {"warm_polar_kernels", "polar"}
    assert got["lm_graphs"] == {"captures": 0, "replays": 0}
    assert got["solver_graphs"] == {prog: {"captures": 0, "replays": 0}
                                    for prog in graphs.PROGRAMS}


def _side_stand_in(s, ue, x, nu, n_crit=9.0, x_forced_transition=1.0):
    """A side march's stand-in (every lane laminar, no transition)."""
    one, (s2, ue2, x2) = march._as_lanes(s, ue, x)
    theta = 1e-4 * (1.0 + s2) * (1.0 + 0.1 * ue2)
    false = torch.zeros_like(s2, dtype=torch.bool)
    bl = march.BLState(theta, 2.2 * theta, torch.full_like(s2, 2.2),
                       1e-3 * ue2, torch.zeros_like(s2),
                       torch.full_like(s2, torch.nan), false, false,
                       x2[:, -1].clone())
    return march.BLState(*(a[0] for a in bl)) if one else bl


def _wake_stand_in(s, ue, nu, theta0, dstar0, ctau0):
    one, (s2, ue2) = march._as_lanes(s, ue)
    theta = march._lanes(theta0, s2)[:, None] * (1.0 + 0.1 * s2)
    out = (theta, 1.5 * theta, torch.full_like(s2, 1.5))
    return tuple(a[0] for a in out) if one else out


@pytest.fixture
def program_keys(monkeypatch):
    """Every (program, key) that reaches ``viscous.graphs``, with stand-in
    marches and LM iterations that leave the state as it is."""
    seen = []
    run = graphs.run

    def record(program, key, body, flat):
        seen.append((program, key))
        return run(program, key, body, flat)

    def lm(key, body, flat, iters):
        seen.append(("lm", key))
        return flat[0], flat[1]

    monkeypatch.setattr(graphs, "run", record)
    monkeypatch.setattr(graphs, "run_lm", lm)
    monkeypatch.setattr(march_kernel, "march_side", _side_stand_in)
    monkeypatch.setattr(march_kernel, "march_wake", _wake_stand_in)
    return seen


def test_warm_polar_kernels_reaches_every_key_of_the_polar(program_keys,
                                                            monkeypatch):
    monkeypatch.setattr(sweep, "_N_STATIONS", 16)
    sweep.warm_polar_kernels(p=5, device="cpu")
    warmed = set(program_keys)
    programs = ("prepare", "reproject", "lm", "settle", "answer")
    per = {prog: {k for p, k in warmed if p == prog} for prog in programs}
    # The pass (8 lanes, 8 warm passes), the walk's continuation (1 lane,
    # 1 warm pass, a start state), the rescue (min(8, 8) lanes): three
    # set-ups; the rescue's round and answer keys are the pass's.
    assert {(k[1], k[6], k[7]) for k in per["prepare"]} == {
        ((8,), 8, False), ((1,), 1, True)}
    assert len([k for p, k in program_keys if p == "prepare"]) == 3
    for prog in programs[1:]:
        assert {k[1] for k in per[prog]} == {(8,), (1,)}
    program_keys.clear()
    sweep.solve_polar(naca4(2, 4, 12, 80), [-2.0, 0.0, 2.0, 4.0, 6.0], 1e6,
                      device="cpu")
    assert program_keys and set(program_keys) <= warmed
    assert {p for p, _k in program_keys} >= {"operator", "inviscid"}


def test_warm_direct_solve_reaches_the_last_resort_key(program_keys,
                                                       monkeypatch):
    analyze.warm_direct_solve(device="cpu")
    warmed = [k for k in program_keys if k[0] == "direct"]
    assert len(warmed) == 1
    program_keys.clear()
    no = torch.tensor(False)
    # Both Newton strategies flag a wrong basin: the direct solve answers.
    monkeypatch.setattr(analyze, "solve_viscous_newton",
                        lambda *a, **kw: SimpleNamespace(converged=no))
    monkeypatch.setattr(analyze, "solve_polar_point",
                        lambda *a, **kw: (None, (no, None)))
    analyze.analyze_airfoil(naca4(0, 0, 12, 80), reynolds=3e5, alpha=7.0,
                            device="cpu")
    assert [k for k in program_keys if k[0] == "direct"][0] == warmed[0]
