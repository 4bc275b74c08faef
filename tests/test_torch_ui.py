"""The port's Streamlit studio (``airfoil_tpu_torch/ui``) under test doubles
of streamlit and plotly (``torch_streamlit_stub``), which neither machine
installs.

The home page (``ui/app.py``), run as Streamlit runs it (``runpy``), with
``BACKEND_URL`` at a live in-process ``make_server(device="cpu")``,
reports the backend online and the ``/stats`` count; at a closed port it
names ``python -m airfoil_tpu_torch.api.server``. The analysis page with
no file runs to its end; without a backend it stops with the same hint.
Its ``flow_visuals`` heatmap (the port's field on the CPU) decodes to the
reference page's pixels (the JAX field), as ``tests/test_torch_flowviz.py``
holds the renderers: equal. The wind-tunnel viewer is the reference's but
for its tag line; the About page runs and names no TPU.
"""

import base64
import io
import os
import runpy
import sys
import threading

import numpy as np
import pytest

import torch_streamlit_stub
from airfoil_tpu.models import naca4
from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.device import ENV_VAR
from airfoil_tpu_torch.utils import stats as port_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_UI = os.path.join(ROOT, "airfoil_tpu_torch", "ui")
REF_UI = os.path.join(ROOT, "airfoil_tpu", "ui")
HINT = "python -m airfoil_tpu_torch.api.server"


@pytest.fixture
def st(monkeypatch):
    """Fresh doubles on ``sys.modules``; the streamlit double."""
    mods = torch_streamlit_stub.modules()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods["streamlit"]


@pytest.fixture(scope="module")
def backend():
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


@pytest.fixture
def closed_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _run(path: str) -> tuple[dict, bool]:
    """The script's globals and whether it ran to its end."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(os.path.dirname(path))
        g = {}
        try:
            g = runpy.run_path(path, run_name="__main__")
            return g, True
        except torch_streamlit_stub.StopRun:
            return g, False


def test_home_online(st, backend, monkeypatch, tmp_path):
    monkeypatch.setenv("BACKEND_URL", backend)
    monkeypatch.delenv("DATABASE_URL", raising=False)
    monkeypatch.setattr(port_stats, "_SQLITE_PATH", str(tmp_path / "s.db"))
    port_stats.init_db()
    for _ in range(3):
        port_stats.increment_analysis_count()
    _g, ended = _run(os.path.join(PORT_UI, "app.py"))
    assert ended
    assert st.named("success") == [(f"Solver backend online — {backend}",)]
    assert st.named("metric") == [("Total analyses run", "3")]
    assert st.named("error") == []
    assert st.named("page_link")[0][0] == "pages/1_Airfoil_Analysis.py"


def test_home_unreachable(st, closed_port, monkeypatch):
    monkeypatch.setenv("BACKEND_URL", closed_port)
    _g, ended = _run(os.path.join(PORT_UI, "app.py"))
    assert ended
    (msg,), = st.named("error")
    assert closed_port in msg and f"`{HINT}`" in msg
    assert st.named("success") == [] and st.named("metric") == []


def test_home_names_no_tpu(st, closed_port, monkeypatch):
    monkeypatch.setenv("BACKEND_URL", closed_port)
    _run(os.path.join(PORT_UI, "app.py"))
    text = " ".join(str(a) for _n, args, kw in st.calls
                    for a in (*args, *kw.values()))
    assert "TPU" not in text and "GPU" in text


def test_analysis_page_without_a_file(st, backend, monkeypatch):
    monkeypatch.setenv("BACKEND_URL", backend)
    g, ended = _run(os.path.join(PORT_UI, "pages", "1_Airfoil_Analysis.py"))
    assert ended
    assert st.named("error") == []
    (msg,), = st.named("info")
    assert msg.startswith("Upload a `.dat` airfoil file to begin.")
    assert g["BACKEND_URL"] == backend
    assert g["_VIEWER"] == os.path.join(PORT_UI, "lbm_viewer.html")
    # The sidebar's defaults: one point at Re 1e6, alpha 5.
    assert (g["mode"], g["reynolds"], g["alpha"]) == ("Single point", 1e6,
                                                      5.0)


def test_analysis_page_without_a_backend(st, closed_port, monkeypatch):
    monkeypatch.setenv("BACKEND_URL", closed_port)
    _g, ended = _run(os.path.join(PORT_UI, "pages", "1_Airfoil_Analysis.py"))
    assert not ended
    (msg,), = st.named("error")
    assert f"`{HINT}`" in msg


def _pixels(b64: str) -> np.ndarray:
    import matplotlib.image as mpimg
    png = base64.b64decode(b64)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return mpimg.imread(io.BytesIO(png), format="png")


def test_flow_visuals_heatmap(st, backend, monkeypatch):
    """Page 1's ``flow_visuals`` for NACA 2412 at alpha 5 on the CPU: the
    heatmap's pixels equal the reference page's."""
    monkeypatch.setenv("BACKEND_URL", backend)
    monkeypatch.setenv(ENV_VAR, "cpu")
    page = os.path.join("pages", "1_Airfoil_Analysis.py")
    port, _ = _run(os.path.join(PORT_UI, page))
    ref, _ = _run(os.path.join(REF_UI, page))
    coords = tuple(map(tuple, naca4(2, 4, 12, 60).tolist()))
    png, anim = port["flow_visuals"](coords, 5.0)
    ref_png, _ = ref["flow_visuals"](coords, 5.0)
    got, want = _pixels(png), _pixels(ref_png)
    assert got.shape == want.shape and got.shape[2] in (3, 4)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, got.shape[2]), axis=0)) > 50
    assert type(anim).__name__ == "Figure"


def test_about_page(st):
    _g, ended = _run(os.path.join(PORT_UI, "pages", "2_About.py"))
    assert ended
    (title,), = st.named("title")
    (body,), = st.named("markdown")
    assert "TPU" not in title + body and "GPU" in title + body
    # The parser's success rates are the reference's figures, quoted.
    assert "~22% to ~86%" in body


def test_viewer_is_the_reference_but_its_tag_line():
    with open(os.path.join(PORT_UI, "lbm_viewer.html"), encoding="utf-8") as f:
        port = f.read().splitlines()
    with open(os.path.join(REF_UI, "lbm_viewer.html"), encoding="utf-8") as f:
        ref = f.read().splitlines()
    assert len(port) == len(ref)
    differ = [i for i, (a, b) in enumerate(zip(port, ref)) if a != b]
    assert differ == [16]
    assert "TPU server-side" in ref[16]
    assert "GPU server-side" in port[16] and "TPU" not in port[16]
