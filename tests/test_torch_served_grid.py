"""The served lattice of ``/lbm/start``: its optional ``nx`` on both
transports (the port's minihttp over real HTTP and ``api/server.py`` under
the FastAPI doubles of ``torch_fastapi_stub``), on the CPU.

A session opened at 128 x 64 (the accepted widths, ``config.LBM_WIDTHS``,
widened to 128 for the test: the service serves 384 and 2048) steps
``config.lbm_steps_per_frame(128)`` = 4 a frame and follows the
benchmark's plain reference tunnel
(``portbench/configs/aerolab-wind-tunnel.py``, float64) through a slider
move: step and angle exactly, the forces and the fields within float32's
rounding. A start without ``nx`` is the viewer's 384 x 192 at 4 steps,
its frames as before; a width outside the accepted set gets a 400 with a
``detail``.
"""

import asyncio
import importlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import requests
import torch

import torch_fastapi_stub as stub
from airfoil_tpu_torch import config
from airfoil_tpu_torch.api import handlers
from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.device import ENV_VAR
from airfoil_tpu_torch.lbm import kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import registry  # noqa: E402
from portbench.airfoils.naca4 import naca4, selig_text  # noqa: E402

REFERENCE = registry.load_module("configs", "aerolab-wind-tunnel")
LATTICE = dict(registry.load_json("configs", "aerolab-wind-tunnel")
               ["lattice"], nx=128, ny=64, steps_per_frame=4)
SERVER = "airfoil_tpu_torch.api.server"
ALPHAS = (6.0, 6.0, 9.5, 9.5)            # the slider moves at the third
FIELDS = "speed,ux,uy"
# The reply rounds cl and cd to 1e-4 (5e-5 either way); float32 adds
# 2.8e-5 at most over 32 steps of this lattice, so 1e-4 beyond the
# rounding.
FORCE_TOL = 5e-5 + 1e-4
# |u| / U0 and u / U0 differ from float64 by 7.5e-6 at most over 32 steps
# of this lattice.
FIELD_TOL = 5e-5
SEP_BAND = 1e-3      # the benchmark's band of the reversed-flow count


def _dat() -> bytes:
    return selig_text("NACA 2412", naca4(0.02, 0.4, 0.12, 100))


@pytest.fixture
def small_widths(monkeypatch):
    monkeypatch.setattr(config, "LBM_WIDTHS", (128,) + config.LBM_WIDTHS)


@pytest.fixture(scope="module")
def base_url():
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _forget(name: str) -> None:
    sys.modules.pop(name, None)
    parent, _, child = name.rpartition(".")
    if parent in sys.modules and hasattr(sys.modules[parent], child):
        delattr(sys.modules[parent], child)


@pytest.fixture
def fastapi_app(monkeypatch):
    """The port's ``create_app`` under the FastAPI doubles, on the CPU;
    the module is forgotten afterwards, so that a later import sees no
    FastAPI again."""
    for name, mod in stub.modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setenv(ENV_VAR, "cpu")
    _forget(SERVER)
    yield importlib.import_module(SERVER).create_app(device="cpu")
    _forget(SERVER)


class Minihttp:
    def __init__(self, url):
        self.url = url

    def start(self, **form):
        r = requests.post(self.url + "/lbm/start", data=form,
                          files={"file": ("naca2412.dat", _dat())},
                          timeout=120)
        return r.status_code, r.json() if r.status_code == 200 \
            else r.json()["detail"]

    def frame(self, **form) -> bytes:
        r = requests.post(self.url + "/lbm/frame", data=form, timeout=120)
        assert r.status_code == 200, r.text
        return r.content


class FastAPI:
    def __init__(self, app):
        self.app = app

    def _call(self, path, **kwargs):
        try:
            return 200, asyncio.run(self.app.route("POST", path)(
                request=stub.Request(), **kwargs))
        except stub.HTTPException as e:
            return e.status_code, e.detail

    def start(self, alpha=6.0, nx=None):
        return self._call("/lbm/start",
                          file=stub.UploadFile("naca2412.dat", _dat()),
                          alpha=alpha, nx=nx)

    def frame(self, session, alpha=None, fields="speed") -> bytes:
        status, out = self._call("/lbm/frame", session=session, alpha=alpha,
                                 u0=None, fields=fields)
        assert status == 200, out
        return out.body


@pytest.fixture(params=["minihttp", "fastapi"])
def transport(request):
    if request.param == "minihttp":
        return Minihttp(request.getfixturevalue("base_url"))
    return FastAPI(request.getfixturevalue("fastapi_app"))


def test_served_grid_follows_the_reference(transport, small_widths):
    status, meta = transport.start(alpha=6.0, nx="128")
    assert status == 200, meta
    assert (meta["grid"], meta["steps_per_frame"]) == ([64, 128], 4)
    tunnel = REFERENCE.Tunnel(REFERENCE.parse_selig(_dat().decode()),
                              LATTICE, 6.0, "cpu", torch.float64, SEP_BAND)
    for k, alpha in enumerate(ALPHAS):
        frame = json.loads(transport.frame(session=meta["session"],
                                           alpha=alpha, fields=FIELDS))
        if alpha != tunnel.alpha:
            tunnel.set_alpha(alpha)
        ref = tunnel.frame(LATTICE["steps_per_frame"], True)
        assert frame["step"] == ref["step"] == 4 * (k + 1)
        assert frame["alpha"] == alpha
        for key in ("cl", "cd"):
            assert abs(frame[key] - ref[key]) <= FORCE_TOL, key
        lo, hi = ref["separation_band"]
        assert lo - 5e-5 <= frame["separation"] <= hi + 5e-5
        for name in FIELDS.split(","):
            got = REFERENCE.decode(frame["fields"][name])
            exp = ref["fields"][name]
            assert got.shape == (64, 128)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
            scale = REFERENCE.FIELDS[name] or LATTICE["u0"]
            fluid = ~np.isnan(exp)
            assert np.abs(got[fluid] - exp[fluid]).max() / scale \
                <= FIELD_TOL, name


def test_start_without_the_fields_is_unchanged(transport):
    """No ``nx``: the default 384 x 192 lattice at 4 steps a frame, the
    reply as before with the steps a frame; naming the default width opens
    the same session, whose frames are the same bytes."""
    status, meta = transport.start(alpha=6.0)
    assert status == 200
    cfg = config.DEFAULT_LBM
    assert {k: v for k, v in meta.items() if k != "session"} == {
        "grid": [cfg.ny, cfg.nx], "domain": [cfg.dx0, cfg.dx1, cfg.dy0,
                                             cfg.dy1],
        "tau": cfg.tau, "u0": cfg.u0, "steps_per_frame": 4}
    status, named = transport.start(alpha=6.0, nx="384")
    assert status == 200
    assert {k: v for k, v in named.items() if k != "session"} == \
        {k: v for k, v in meta.items() if k != "session"}
    for alpha in (6.0, 8.0):
        a, b = (transport.frame(session=m["session"], alpha=alpha,
                                fields="speed") for m in (meta, named))
        assert a == b
        assert json.loads(a)["step"] == (4 if alpha == 6.0 else 8)


@pytest.mark.parametrize("nx", [
    "128", "256", "2176", "4096", "400", "1000", "abc", "2048.0", "512",
    "1024", "0", "-2048"])
def test_lattice_outside_the_set_is_refused(base_url, nx):
    status, detail = Minihttp(base_url).start(alpha=6.0, nx=nx)
    assert status == 400
    assert "nx" in detail


def test_fastapi_refuses_a_lattice_outside_the_set(fastapi_app):
    api = FastAPI(fastapi_app)
    assert api.start(nx="4096") == (
        400, "nx must be one of 384, 2048, got 4096")
    assert api.start(nx="x") == (400, "Field 'nx' must be an integer")


def test_accepted_set():
    """Square cells on the fixed domain, whole 32 x 16 tiles of the tiled
    kernel, the default among the widths, and the steps a frame that keep
    the reference viewer's convective time (4 at 320 wide) in rounds of
    4."""
    assert config.LBM_WIDTHS == (config.DEFAULT_LBM.nx, 2048) == (384, 2048)
    assert all(nx % 128 == 0 for nx in config.LBM_WIDTHS)
    assert [config.lbm_steps_per_frame(nx) for nx in (128, 384, 2048)] == \
        [4, 4, 24]
    assert handlers.lbm_config() is config.DEFAULT_LBM
    assert handlers.lbm_config("384") == config.DEFAULT_LBM
    large = handlers.lbm_config(2048)
    assert (large.ny, large.nx, large.steps_per_frame) == (1024, 2048, 24)
    for cfg in (config.DEFAULT_LBM, large):
        assert cfg.ny / cfg.nx == pytest.approx(
            (cfg.dy1 - cfg.dy0) / (cfg.dx1 - cfg.dx0), rel=1e-12)


def test_served_widths_pick_their_kernel():
    """On an H100 (132 SMs, 227 KiB of shared memory a block) the
    viewer's width fits the resident kernel and the large tunnel goes to
    the tiled one, which ``WindTunnel`` then steps."""
    h100 = (132, 232_448)
    picks = [kernel.prefers_tiled(cfg.ny, cfg.nx, *h100)
             for cfg in map(handlers.lbm_config, config.LBM_WIDTHS)]
    assert picks == [False, True]
