"""The port's service (``airfoil_tpu_torch.api``) over real HTTP.

The port's server runs on the CPU with an explicit ``device="cpu"``; the
session lifecycle mirrors tests/test_api.py::TestLBM, and the response
keys are held to the JAX server's for the same upload. ``/upload_airfoil/``
is held to the JAX handler: the same 400 answers, and through a stubbed
``analyze_airfoil`` (the real one takes minutes on a CPU; the goldens and
``chip_smoke.py`` hold it) the same 200 reply, run log and analysis count.
"""

import base64
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import requests
import torch

from airfoil_tpu.api import handlers as jax_handlers
from airfoil_tpu.api.minihttp import make_server as make_jax_server
from airfoil_tpu.polar.analyze import AnalysisResult as JaxAnalysisResult
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.api import handlers as port_handlers
from airfoil_tpu_torch.api.minihttp import NOT_PORTED, make_server
from airfoil_tpu_torch.polar import AnalysisResult
from airfoil_tpu_torch.utils import stats as port_stats
from airfoil_tpu_torch.device import ENV_VAR, resolve_device
from airfoil_tpu_torch.lbm.runner import WindTunnel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def base_url():
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    yield _serve(httpd)
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def naca2412_dat():
    lines = ["TEST AIRFOIL"] + [f" {x:.6f} {y:.6f}"
                                for x, y in naca4(2, 4, 12, 60)]
    return "\n".join(lines).encode()


def _start(url, dat, alpha=6.0):
    r = requests.post(url + "/lbm/start", data={"alpha": alpha},
                      files={"file": ("naca2412.dat", dat)}, timeout=120)
    assert r.status_code == 200, r.text
    return r.json()


def _frame(url, session, **data):
    return requests.post(url + "/lbm/frame",
                         data={"session": session, **data}, timeout=120)


class TestBasics:
    def test_root(self, base_url):
        r = requests.get(base_url + "/")
        assert r.status_code == 200 and r.json()["status"] == "ok"

    def test_health_reports_torch_device(self, base_url):
        body = requests.get(base_url + "/health").json()
        assert body["status"] == "healthy"
        assert body["solver"] == "airfoil_tpu_torch"
        assert body["backend"] == "cpu" and body["accelerator"] is False

    def test_static_app_served(self, base_url):
        r = requests.get(base_url + "/app")
        assert r.status_code == 200 and "<html" in r.text.lower()

    def test_unknown_route(self, base_url):
        assert requests.get(base_url + "/nope").status_code == 404

    @pytest.mark.parametrize("path", NOT_PORTED)
    def test_unported_routes_501(self, base_url, naca2412_dat, path):
        if path == "/stats":
            r = requests.get(base_url + path)
        else:
            r = requests.post(base_url + path,
                              data={"reynolds": 1e6, "alpha": 4.0},
                              files={"file": ("a.dat", naca2412_dat)})
        assert r.status_code == 501
        assert "not yet ported" in r.json()["detail"]


def _analysis(cls, mode="viscous"):
    """A made-up analysis result of the given package's class."""
    coeffs = {"CL": 0.7938, "CD": 0.007031, "CDp": 0.002151, "Cm": -0.0505,
              "mode": mode}
    bl = {"upper": [{"x": 1.0, "y": 0.001, "dstar": 0.004, "theta": 0.002,
                     "cf": 0.003, "H": 2.0}],
          "lower": [{"x": 0.0, "y": 0.0, "dstar": 1e-5, "theta": 5e-6,
                     "cf": 0.05, "H": 2.2}],
          "transition_upper_x": 0.31, "transition_lower_x": None}
    return cls(cp_x=[0.0, 0.5, 1.0], cp_values=[1.0, -0.5, 0.1],
               coefficients=coeffs, bl_data=bl, mode=mode, strategy=1,
               converged=True, sep_fraction=0.0125)


@pytest.fixture
def stubbed_analysis(monkeypatch, tmp_path):
    """Both packages' ``analyze_airfoil`` answering a made-up result, the
    run logs under ``tmp_path`` and the port's counter in a fresh file;
    yields the port's (alpha, device) calls."""
    import airfoil_tpu.polar
    import airfoil_tpu_torch.polar

    calls = []

    def port_stub(coords, reynolds, alpha, device=None):
        calls.append((alpha, device))
        return _analysis(AnalysisResult)

    monkeypatch.setattr(airfoil_tpu_torch.polar, "analyze_airfoil", port_stub)
    monkeypatch.setattr(airfoil_tpu.polar, "analyze_airfoil",
                        lambda c, r, a: _analysis(JaxAnalysisResult))
    monkeypatch.setenv("AIRFOIL_TPU_RUN_LOG_DIR", str(tmp_path / "runs"))
    monkeypatch.setattr(port_stats, "_SQLITE_PATH", str(tmp_path / "s.db"))
    monkeypatch.setattr(jax_handlers, "increment_analysis_count", lambda: 1)
    yield calls


class TestUpload:
    @pytest.mark.parametrize("name,reynolds,alpha,kind,word", [
        ("a.dat", 1e3, 5.0, "naca", "Reynolds"),
        ("a.dat", 1e6, 45.0, "naca", "Alpha"),
        ("a.txt", 1e6, 5.0, "naca", ".dat"),
        ("a.dat", 1e6, 5.0, "double", "Multi-element"),
        ("a.dat", 1e6, 5.0, "garbage", "Insufficient")])
    def test_validation_answers(self, base_url, naca2412_dat, name, reynolds,
                                alpha, kind, word):
        """The 400 answers, equal to the JAX handler's."""
        loop = naca4(2, 4, 12, 40)
        content = {"naca": naca2412_dat, "garbage": b"not an airfoil at all",
                   "double": "\n".join(
                       f"{x:.6f} {y:.6f}"
                       for x, y in np.concatenate([loop, loop])).encode()}[kind]
        r = requests.post(base_url + "/upload_airfoil/",
                          data={"reynolds": reynolds, "alpha": alpha},
                          files={"file": (name, content)}, timeout=60)
        assert r.status_code == 400 and word in r.json()["detail"]
        with pytest.raises(jax_handlers.ApiError) as err:
            jax_handlers.handle_upload(name, content, reynolds, alpha)
        assert (err.value.status_code, err.value.detail) == \
            (400, r.json()["detail"])

    def test_missing_field(self, base_url, naca2412_dat):
        r = requests.post(base_url + "/upload_airfoil/",
                          data={"reynolds": 1e6},
                          files={"file": ("a.dat", naca2412_dat)})
        assert r.status_code == 400 and "alpha" in r.json()["detail"]

    def test_reply_equals_the_jax_handlers(self, base_url, naca2412_dat,
                                           stubbed_analysis):
        r = requests.post(base_url + "/upload_airfoil/",
                          data={"reynolds": 1e6, "alpha": 5.0},
                          files={"file": ("naca2412.dat", naca2412_dat)},
                          timeout=60)
        assert r.status_code == 200, r.text
        status, want = jax_handlers.handle_upload("naca2412.dat",
                                                  naca2412_dat, 1e6, 5.0)
        assert status == 200
        assert r.json() == json.loads(json.dumps(want))
        assert set(r.json()) == {
            "success", "coords_before", "coords_after", "num_points",
            "cp_x", "cp_values", "coefficients", "bl_data", "parser_fixes"}
        # Solved on the server's device.
        assert stubbed_analysis == [(5.0, torch.device("cpu"))]

    def test_counts_and_logs_each_analysis(self, naca2412_dat, tmp_path,
                                           stubbed_analysis):
        for k in (1, 2):
            port_handlers.handle_upload("naca2412.dat", naca2412_dat, 1e6,
                                        5.0, device="cpu")
            assert port_stats.get_analysis_count() == k
            assert len(os.listdir(tmp_path / "runs")) == k

    def test_write_run_log_equals_the_jax_one(self, tmp_path, monkeypatch):
        logs = {}
        for key, mod, cls in (("port", port_handlers, AnalysisResult),
                              ("jax", jax_handlers, JaxAnalysisResult)):
            monkeypatch.setenv("AIRFOIL_TPU_RUN_LOG_DIR", str(tmp_path / key))
            mod._write_run_log("ab12cd34", "naca2412.dat", 1e6, 5.0, 121,
                               ["closed the trailing edge"],
                               _analysis(cls, "inviscid"), 1.25)
            (name,) = os.listdir(tmp_path / key)
            assert name.endswith("_ab12cd34.log")
            logs[key] = (tmp_path / key / name).read_text()
        assert logs["port"] == logs["jax"]
        assert "mode: inviscid" in logs["port"]
        monkeypatch.setenv("AIRFOIL_TPU_RUN_LOG_DIR", "")
        port_handlers._write_run_log("x", "a.dat", 1e6, 5.0, 1, [],
                                     _analysis(AnalysisResult), 0.1)
        assert sorted(os.listdir(tmp_path)) == ["jax", "port"]

    def test_stats_counter(self, tmp_path, monkeypatch):
        monkeypatch.setattr(port_stats, "_SQLITE_PATH", str(tmp_path / "c.db"))
        monkeypatch.delenv("DATABASE_URL", raising=False)
        port_stats.init_db()
        assert port_stats.get_analysis_count() == 0
        assert [port_stats.increment_analysis_count() for _ in range(3)] \
            == [1, 2, 3]
        assert port_stats.get_analysis_count() == 3
        monkeypatch.setattr(port_stats, "_SQLITE_PATH",
                            str(tmp_path / "no" / "such" / "dir.db"))
        assert port_stats.increment_analysis_count() is None   # no-op


class TestLBM:
    def test_session_lifecycle(self, base_url, naca2412_dat):
        meta = _start(base_url, naca2412_dat)
        session = meta["session"]
        ny, nx = meta["grid"]
        assert ny > 0 and nx > 0

        r2 = _frame(base_url, session, fields="speed,ux,uy")
        assert r2.status_code == 200, r2.text
        frame = r2.json()
        assert frame["step"] > 0
        assert set(frame["fields"]) == {"speed", "ux", "uy"}
        arr = np.frombuffer(base64.b64decode(frame["fields"]["speed"]["data"]),
                            np.float32)
        assert arr.size == ny * nx
        assert np.isnan(arr).any() and np.isfinite(arr).sum() > ny * nx // 2

        r3 = _frame(base_url, session, alpha=12.0, fields="speed")
        assert r3.status_code == 200 and r3.json()["alpha"] == 12.0
        assert r3.json()["step"] == 2 * frame["step"]

        assert requests.post(base_url + "/lbm/stop",
                             data={"session": session}).status_code == 200
        assert _frame(base_url, session).status_code == 404

    def test_bad_upload_rejected(self, base_url):
        r = requests.post(base_url + "/lbm/start", data={"alpha": 6.0},
                          files={"file": ("a.dat", b"not an airfoil")})
        assert r.status_code == 400
        assert "Insufficient" in r.json()["detail"]

    def test_response_keys_match_jax_server(self, base_url, naca2412_dat):
        jax_httpd = make_jax_server(host="127.0.0.1", port=0,
                                    rate_limit=False)
        jax_url = _serve(jax_httpd)
        try:
            metas, frames = [], []
            for url in (base_url, jax_url):
                meta = _start(url, naca2412_dat)
                r = _frame(url, meta["session"],
                           fields="speed,cp,vorticity,ux,uy")
                assert r.status_code == 200, r.text
                metas.append(meta)
                frames.append(r.json())
        finally:
            jax_httpd.shutdown()
            jax_httpd.server_close()
        port_meta, jax_meta = metas
        assert set(port_meta) == set(jax_meta)
        assert {k: v for k, v in port_meta.items() if k != "session"} == \
            {k: v for k, v in jax_meta.items() if k != "session"}
        port_frame, jax_frame = frames
        assert set(port_frame) == set(jax_frame)
        assert set(port_frame["fields"]) == set(jax_frame["fields"])
        for k, field in port_frame["fields"].items():
            assert set(field) == set(jax_frame["fields"][k])
            assert field["shape"] == jax_frame["fields"][k]["shape"]
        assert port_frame["step"] == jax_frame["step"]
        assert port_frame["outline"] == jax_frame["outline"]


class TestCopiedValidation:
    """``parse_upload`` and ``validate_envelope`` are copies of the JAX
    package's (whose module imports jax); they must answer alike."""

    @pytest.mark.parametrize("reynolds,alpha", [
        (1e6, 5.0), (1e3, 5.0), (2e7, 5.0), (1e6, -11.0), (1e6, 21.0)])
    def test_validate_envelope(self, reynolds, alpha):
        from airfoil_tpu.api import handlers as jax_handlers
        from airfoil_tpu_torch.api import handlers

        def outcome(mod):
            try:
                mod.validate_envelope(reynolds, alpha)
            except mod.ApiError as e:
                return e.status_code, e.detail
            return None

        assert outcome(handlers) == outcome(jax_handlers)

    @pytest.mark.parametrize("name,content", [
        ("a.dat", b"not an airfoil"), ("a.txt", b"1 0\n0 0\n"),
        ("ok.dat", None)])
    def test_parse_upload(self, naca2412_dat, name, content):
        from airfoil_tpu.api import handlers as jax_handlers
        from airfoil_tpu_torch.api import handlers

        content = naca2412_dat if content is None else content

        def outcome(mod):
            try:
                return mod.parse_upload(name, content)
            except mod.ApiError as e:
                return e.status_code, e.detail

        assert outcome(handlers) == outcome(jax_handlers)


class TestRateLimit:
    def test_lbm_start_limited(self):
        httpd = make_server(host="127.0.0.1", port=0, device="cpu")
        url = _serve(httpd)
        try:
            codes = [requests.post(url + "/lbm/start",
                                   files={"file": ("a.dat", b"bad")},
                                   timeout=30).status_code
                     for _ in range(6)]
            assert codes[:5] == [400] * 5 and codes[5] == 429
            assert requests.get(url + "/health").status_code == 200
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_upload_limited(self):
        """``/upload_airfoil/`` is a solve: 5 a minute from one address."""
        httpd = make_server(host="127.0.0.1", port=0, device="cpu")
        url = _serve(httpd)
        try:
            codes = [requests.post(url + "/upload_airfoil/",
                                   data={"reynolds": 1e6, "alpha": 5.0},
                                   files={"file": ("a.txt", b"bad")},
                                   timeout=30).status_code
                     for _ in range(6)]
            assert codes[:5] == [400] * 5 and codes[5] == 429
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestDevicePolicy:
    def test_env_var_selects_cpu(self, monkeypatch):
        monkeypatch.setenv(ENV_VAR, "cpu")
        assert resolve_device().type == "cpu"
        assert resolve_device("cpu").type == "cpu"

    def test_cuda_without_a_card_raises(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; nothing to refuse")
        monkeypatch.delenv(ENV_VAR, raising=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WindTunnel(naca4(2, 4, 12, 40), device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_server(host="127.0.0.1", port=0, device="cuda")

    def test_tf32_off(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax():
    """Import the port, its LBM and its server, run one CPU frame, and
    check that JAX was never loaded (a subprocess: conftest imports jax)."""
    script = textwrap.dedent("""
        import sys
        import airfoil_tpu_torch
        import airfoil_tpu_torch.lbm
        import airfoil_tpu_torch.api.minihttp
        from airfoil_tpu.config import LBMConfig
        from airfoil_tpu.models import naca4
        from airfoil_tpu_torch.lbm import WindTunnel

        wt = WindTunnel(naca4(2, 4, 12, 40), cfg=LBMConfig(nx=64, ny=32))
        out = wt.frame()
        assert out["step"] == 4 and wt.device.type == "cpu"
        loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        assert not loaded, loaded
        print("NO_JAX_OK")
    """)
    env = {**os.environ, ENV_VAR: "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
