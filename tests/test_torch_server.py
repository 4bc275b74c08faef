"""The port's service entry point, ``airfoil_tpu_torch.api.server``.

(a) ``python -m airfoil_tpu_torch.api.server`` in a child process on the
CPU (``AIRFOIL_TPU_TORCH_DEVICE=cpu``, a free ``PORT``): without FastAPI
it serves minihttp, and its answers (``/``, ``/health``, ``/stats``, a
wind-tunnel session of two frames) equal an in-process
``make_server(device="cpu")``'s. Without a device named and without a
card it exits with the device error.

(b) Under test doubles of FastAPI and slowapi (``torch_fastapi_stub``),
the reference's ``create_app()`` and the port's ``create_app(device=
"cpu")`` register the same routes with the same limits, form defaults and
CORS options, and their route coroutines, called directly with the same
uploads (the solves on anyio worker threads), answer alike: the same JSON
for ``/``, ``/health`` (but the fields naming the solver and device),
``/stats`` and a wind-tunnel session (the fields within the LBM tests'
tolerance; the port's frames a JSON ``Response`` of ``encode_reply``'s
bytes), and the same ``HTTPException`` for malformed uploads.
"""

import asyncio
import base64
import importlib
import inspect
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import requests

import torch_fastapi_stub as stub
from airfoil_tpu.models import naca4
from airfoil_tpu.utils import stats as ref_stats
from airfoil_tpu_torch import config
from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.device import ENV_VAR
from airfoil_tpu_torch.utils import stats as port_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS = ("airfoil_tpu.api.server", "airfoil_tpu_torch.api.server")
# The LBM tests' bar (tests/test_torch_lbm.py): the Pallas tests' own.
RTOL, ATOL = 1e-5, 1e-6
FIELDS = "speed,cp,vorticity"


def _dat() -> bytes:
    return ("NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                      for x, y in naca4(2, 4, 12, 60))
            ).encode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _session(get, post) -> list:
    """``/``, ``/stats``, ``/lbm/start``, two ``/lbm/frame`` (the second
    at a new alpha) and ``/lbm/stop``, each reply's session id blanked."""
    out = [get("/"), get("/stats")]
    meta = post("/lbm/start", {"alpha": 6.0},
                {"file": ("naca2412.dat", _dat())})
    session = meta.pop("session")
    out.append(meta)
    out.append(post("/lbm/frame", {"session": session, "fields": FIELDS}))
    out.append(post("/lbm/frame", {"session": session, "fields": FIELDS,
                                   "alpha": 8.0}))
    stopped = post("/lbm/stop", {"session": session})
    assert stopped == {"stopped": session}
    return out


def _http(url):
    def get(path):
        r = requests.get(url + path, timeout=120)
        assert r.status_code == 200, r.text
        return r.json()

    def post(path, data, files=None):
        r = requests.post(url + path, data=data, files=files, timeout=120)
        assert r.status_code == 200, r.text
        return r.json()
    return get, post


@pytest.fixture
def stats_db(tmp_path, monkeypatch):
    path = str(tmp_path / "stats.db")
    monkeypatch.delenv("DATABASE_URL", raising=False)
    monkeypatch.setattr(port_stats, "_SQLITE_PATH", path)
    monkeypatch.setattr(ref_stats, "_SQLITE_PATH", path)
    port_stats.init_db()
    port_stats.increment_analysis_count()
    return path


def test_entry_serves_minihttp_on_the_cpu(stats_db, tmp_path):
    port = _free_port()
    env = dict(os.environ, PORT=str(port), AIRFOIL_TPU_STATS_PATH=stats_db,
               PYTHONPATH=REPO)
    env[ENV_VAR] = "cpu"
    env.pop("DATABASE_URL", None)
    log_path = tmp_path / "server.log"
    with open(log_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-m", "airfoil_tpu_torch.api.server"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 90
        while True:
            assert child.poll() is None, log_path.read_text()[-3000:]
            try:
                health = requests.get(url + "/health", timeout=5).json()
                break
            except requests.ConnectionError:
                assert time.monotonic() < deadline, "the server never came up"
                time.sleep(0.5)
        assert health["backend"] == "cpu" and health["device"] == "cpu"
        assert not health["accelerator"]
        assert "transport: minihttp (FastAPI not installed)" in \
            log_path.read_text()
        local = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert requests.get(local + "/health", timeout=5).json() == health
        got = _session(*_http(url))
        want = _session(*_http(local))
        assert got == want
        assert got[1] == {"total_analyses": 1}
        for frame in got[3:]:
            for field in frame["fields"].values():
                a = np.frombuffer(base64.b64decode(field["data"]), np.float32)
                assert np.isfinite(a).any()
        assert child.poll() is None, "the server exited early"
    finally:
        child.terminate()
        try:
            child.wait(timeout=20)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_entry_without_a_card_raises():
    env = dict(os.environ, PORT=str(_free_port()), PYTHONPATH=REPO)
    env.pop(ENV_VAR, None)
    proc = subprocess.run(
        [sys.executable, "-m", "airfoil_tpu_torch.api.server"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr


# ── (b) the FastAPI transport under the test doubles ──────────────────────

def _forget(name: str) -> None:
    sys.modules.pop(name, None)
    parent, _, child = name.rpartition(".")
    if parent in sys.modules and hasattr(sys.modules[parent], child):
        delattr(sys.modules[parent], child)


@pytest.fixture
def fastapi_stub(monkeypatch):
    """The doubles on ``sys.modules`` (the CPU device named), both server
    modules imported afresh under them; afterwards both are forgotten, so
    that a later import sees no FastAPI again."""
    for name, mod in stub.modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setenv(ENV_VAR, "cpu")
    for name in SERVERS:
        _forget(name)
    yield
    for name in SERVERS:
        _forget(name)


@pytest.fixture
def apps(fastapi_stub):
    ref = importlib.import_module("airfoil_tpu.api.server")
    port = importlib.import_module("airfoil_tpu_torch.api.server")
    assert ref.HAVE_FASTAPI and port.HAVE_FASTAPI
    return ref.create_app(), port.create_app(device="cpu")


def _call(app, method, path, **kwargs):
    """The route's coroutine run to its end, a ``Form`` field left out
    taking its default as FastAPI gives it: (200, payload), or the
    ``HTTPException``'s (status, detail)."""
    fn = app.route(method, path)
    for p in inspect.signature(fn).parameters.values():
        if isinstance(p.default, stub.FormDefault):
            kwargs.setdefault(p.name, p.default.default)
    try:
        return 200, asyncio.run(fn(request=stub.Request(), **kwargs))
    except stub.HTTPException as e:
        return e.status_code, e.detail


def test_route_and_limit_table(apps):
    ref, port = apps
    assert port.table() == ref.table()
    assert ("POST", "/lbm/start", "10/minute") in port.table()
    assert ("GET", "/health", "20/minute") in port.table()
    assert port.title == ref.title
    assert [(cls.__name__, opts) for cls, opts in port.middleware] == \
        [(cls.__name__, opts) for cls, opts in ref.middleware]
    assert port.middleware[0][1]["allow_origins"] == config.ALLOWED_ORIGINS
    assert set(port.exception_handlers) == set(ref.exception_handlers)
    assert port.state.limiter is not None
    assert len(port.events["startup"]) == len(ref.events["startup"]) == 1


def test_form_defaults(apps):
    """Each route's parameters, with the defaults its ``Form`` fields
    carry."""
    def params(app):
        out = []
        for method, path, fn in app.routes:
            sig = inspect.signature(fn).parameters.values()
            out.append((method, path, [
                (p.name, p.default.default
                 if isinstance(p.default, stub.FormDefault) else None)
                for p in sig]))
        return out

    ref, port = apps
    # The port's /lbm/start also takes the lattice (handlers.lbm_config).
    lattice = [("nx", None)]
    want = [(method, path, names + lattice if path == "/lbm/start" else names)
            for method, path, names in params(ref)]
    assert params(port) == want


def test_startup_hook_warms_the_device(apps, monkeypatch):
    _ref, port = apps
    from airfoil_tpu_torch.api import handlers

    seen = []
    monkeypatch.setattr(handlers, "start_warmup", seen.append)
    asyncio.run(port.events["startup"][0]())
    assert [str(d) for d in seen] == ["cpu"]


def test_root_health_stats(apps, stats_db):
    ref, port = apps
    assert _call(port, "GET", "/") == _call(ref, "GET", "/")
    assert _call(port, "GET", "/stats") == _call(ref, "GET", "/stats") \
        == (200, {"total_analyses": 1})
    for method in ("GET", "HEAD"):
        (s, got), (r, want) = (_call(port, method, "/health"),
                               _call(ref, method, "/health"))
        assert s == r == 200 and set(got) == set(want)
        aside = ("solver", "device")
        assert {k: v for k, v in got.items() if k not in aside} == \
            {k: v for k, v in want.items() if k not in aside}
        assert (got["solver"], got["device"]) == ("airfoil_tpu_torch", "cpu")


def _frames_close(got: dict, want: dict) -> None:
    """Equal but for rounding: the forces within one unit of the reply's
    last digit, the fields within the LBM tests' bar in lattice units
    (speed is |u|/U0 and Cp (rho-1)/(1.5 U0^2), which multiply the
    lattice's float32 differences by ~17 and ~185, as in
    tests/test_torch_lbm_tiled.py), NaN (solid) where the reference's is."""
    assert set(got) == set(want)
    for key in ("step", "alpha", "outline", "reynolds"):
        assert got[key] == want[key], key
    for key in ("cl", "cd", "separation"):
        assert abs(got[key] - want[key]) <= 1e-4 + 1e-9, key
    assert set(got["fields"]) == set(want["fields"]) == set(FIELDS.split(","))
    u0 = np.float32(config.LBMConfig().u0)
    to_lattice = {"speed": lambda a: a * u0,
                  "cp": lambda a: 1.0 + a * np.float32(1.5 * u0 * u0)}
    for name, field in got["fields"].items():
        ref = want["fields"][name]
        assert {k: v for k, v in field.items() if k != "data"} == \
            {k: v for k, v in ref.items() if k != "data"}
        a, b = (np.frombuffer(base64.b64decode(f["data"]), np.float32)
                for f in (field, ref))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fluid = ~np.isnan(b)
        scale = to_lattice.get(name, lambda x: x)
        np.testing.assert_allclose(scale(a[fluid]), scale(b[fluid]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _as_json(answer):
    """The port's ``/lbm/frame`` answer, a ``Response`` of the reply's
    bytes (``handlers.encode_reply``, the default ``json.dumps`` form), as
    JSON."""
    status, out = answer
    assert out.media_type == "application/json"
    payload = json.loads(out.body)
    assert json.dumps(payload).encode() == out.body
    return status, payload


def test_lbm_session(apps):
    replies = []
    for app in apps:
        status, meta = _call(app, "POST", "/lbm/start",
                             file=stub.UploadFile("naca2412.dat", _dat()),
                             alpha=6.0)
        assert status == 200, meta
        session = meta.pop("session")
        frames = [_call(app, "POST", "/lbm/frame", session=session,
                        alpha=alpha, u0=None, fields=FIELDS)
                  for alpha in (None, 8.0)]
        stop = _call(app, "POST", "/lbm/stop", session=session)
        assert stop == (200, {"stopped": session})
        gone = _call(app, "POST", "/lbm/frame", session=session, alpha=None,
                     u0=None, fields="speed")
        replies.append((meta, frames, gone))
    (ref_meta, ref_frames, ref_gone), (meta, frames, gone) = replies
    assert all(isinstance(out, stub.Response) for _, out in frames)
    frames = [_as_json(answer) for answer in frames]
    # The port's start reply also gives the session's steps a frame.
    assert meta == dict(ref_meta,
                        steps_per_frame=config.LBMConfig().steps_per_frame)
    assert gone == ref_gone == (404, "Unknown session")
    for (s, got), (r, want) in zip(frames, ref_frames):
        assert s == r == 200
        _frames_close(got, want)
    assert [f["step"] for _, f in frames] == \
        [config.LBMConfig().steps_per_frame * k for k in (1, 2)]


MALFORMED = {
    "too_few_points": ("bad.dat", b"junk\n0.5 0.1\n0.4 0.05\n"),
    "not_a_dat": ("naca2412.txt", None),
    "empty": ("empty.dat", b""),
}


@pytest.mark.parametrize("route", ["/upload_airfoil/", "/polar/", "/batch/"])
@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_upload(apps, route, case):
    name, content = MALFORMED[case]
    content = _dat() if content is None else content
    answers = []
    for app in apps:
        upload = stub.UploadFile(name, content)
        form = {"/upload_airfoil/": dict(file=upload, reynolds=1e6,
                                         alpha=5.0),
                "/polar/": dict(file=upload, reynolds=1e6, alpha_start=0.0,
                                alpha_end=4.0, alpha_step=2.0),
                "/batch/": dict(files=[upload], reynolds=1e6,
                                alpha=5.0)}[route]
        answers.append(_call(app, "POST", route, **form))
    if route == "/batch/":
        # A batch answers 200 with an error row a file, and its wall time.
        for status, payload in answers:
            assert status == 200 and payload.pop("elapsed_seconds") >= 0
    got, want = answers
    assert got == want
    if route == "/batch/":
        assert [set(row) for row in got[1]["results"]] == [{"file", "error"}]
    else:
        assert got[0] == 400, got


def test_batch_without_files(apps):
    got, want = (_call(app, "POST", "/batch/", files=[], reynolds=1e6,
                       alpha=5.0) for app in apps)
    assert got == want == (400, "No files uploaded")


def test_create_app_without_a_card_raises(fastapi_stub, monkeypatch):
    monkeypatch.delenv(ENV_VAR)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module("airfoil_tpu_torch.api.server")


@pytest.mark.parametrize("have_uvicorn", [True, False])
def test_main_chooses_the_transport(fastapi_stub, monkeypatch, have_uvicorn):
    server = importlib.import_module("airfoil_tpu_torch.api.server")
    from airfoil_tpu_torch.api import minihttp

    calls = []
    uvicorn = types.ModuleType("uvicorn")
    uvicorn.run = lambda app, host, port: calls.append(("uvicorn", app, port))
    monkeypatch.setitem(sys.modules, "uvicorn",
                        uvicorn if have_uvicorn else None)
    monkeypatch.setattr(minihttp, "serve", lambda: calls.append(("minihttp",)))
    server.main()
    assert calls == ([("uvicorn", server.app, config.PORT)] if have_uvicorn
                     else [("minihttp",)])
