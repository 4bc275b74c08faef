"""The spans of the served frame (``utils.profiling.span``) on the CPU.

A ``/lbm/frame`` served by the port's minihttp server on a keep-alive
connection whose thread started before the profiler: under a profiler
that records every thread, each span of the frame appears once a frame,
nested as the request runs it (the transport's ``http /lbm/frame`` around
``http.read``, ``lbm.wait``, ``lbm.frame``, ``lbm.fields``,
``http.encode`` and ``http.write``; ``lbm.step`` and ``lbm.diagnostics``
inside ``lbm.frame``; ``lbm.remask`` where the slider moved). With no
profiler a span calls nothing: a frame served while the profiler's range
raises equals one served without. The gate is pinned: the module flag
``torch.autograd.profiler._is_profiler_enabled`` reads True in a thread
started before an all-threads profiler, where the thread-local
``torch.autograd._profiler_enabled()`` reads False, and a span is a host
record, not a user annotation.
"""

import threading

import pytest
import requests
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.utils import profiling
from airfoil_tpu_torch.utils.profiling import span
from airfoil_tpu_torch.viscous import graphs

FRAME_SPANS = ("http /lbm/frame", "http.read", "lbm.wait", "lbm.frame",
               "lbm.step", "lbm.diagnostics", "lbm.fields", "http.encode",
               "http.write")
INSIDE_REQUEST = ("http.read", "lbm.wait", "lbm.frame", "lbm.fields",
                  "http.encode", "http.write")
INSIDE_FRAME = ("lbm.step", "lbm.diagnostics")
NAMES = FRAME_SPANS + ("lbm.remask",)


def _all_threads():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


@pytest.fixture(scope="module")
def url():
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def dat():
    return "\n".join(["NACA 2412"] + [f" {x:.6f} {y:.6f}" for x, y in
                                      naca4(2, 4, 12, 60)]).encode()


class _Viewer:
    """A session on one keep-alive connection (one server thread)."""

    def __init__(self, url, dat):
        self.url, self.conn = url, requests.Session()
        r = self.conn.post(url + "/lbm/start", data={"alpha": 6.0},
                           files={"file": ("naca2412.dat", dat)},
                           timeout=120)
        assert r.status_code == 200, r.text
        self.session = r.json()["session"]

    def frame(self, **data):
        r = self.conn.post(self.url + "/lbm/frame",
                           data={"session": self.session,
                                 "fields": "speed,ux,uy", **data},
                           timeout=120)
        assert r.status_code == 200, r.text
        return r.json()

    def close(self):
        self.conn.close()


def _traced_frames(url, dat, n, **data):
    """``n`` frames of a session whose connection's server thread started
    before the profiler: the spans of ``NAMES`` as (start, end, name,
    thread), in order."""
    viewer = _Viewer(url, dat)
    try:
        viewer.frame()                 # the connection's thread is running
        with _all_threads() as prof:
            for _ in range(n):
                viewer.frame(**data)
    finally:
        viewer.close()
    return sorted((e.time_range.start, e.time_range.end, e.name, e.thread)
                  for e in prof.events() if e.name in NAMES)


def _inside(inner, outer):
    return outer[0] <= inner[0] <= inner[1] <= outer[1] \
        and inner[3] == outer[3]


def test_frame_spans_once_a_frame_and_nested(url, dat):
    spans = _traced_frames(url, dat, 2)
    names = [s[2] for s in spans]
    for name in FRAME_SPANS:
        assert names.count(name) == 2, (name, names)
    assert "lbm.remask" not in names
    requests_ = [s for s in spans if s[2] == "http /lbm/frame"]
    frames = [s for s in spans if s[2] == "lbm.frame"]
    for s in spans:
        if s[2] in INSIDE_REQUEST:
            assert sum(_inside(s, r) for r in requests_) == 1, s
        if s[2] in INSIDE_FRAME:
            assert sum(_inside(s, f) for f in frames) == 1, s
    # In a request the read, the wait, the frame, the fields, the encode
    # and the write follow each other.
    for r in requests_:
        inner = [s[2] for s in spans
                 if s[2] in INSIDE_REQUEST and _inside(s, r)]
        assert inner == list(INSIDE_REQUEST)


def test_slider_move_shows_remask(url, dat):
    spans = _traced_frames(url, dat, 1, alpha=8.5)
    (remask,) = [s for s in spans if s[2] == "lbm.remask"]
    (request,) = [s for s in spans if s[2] == "http /lbm/frame"]
    (wait,) = [s for s in spans if s[2] == "lbm.wait"]
    (frame,) = [s for s in spans if s[2] == "lbm.frame"]
    assert _inside(remask, request)
    assert wait[1] <= remask[0] and remask[1] <= frame[0]


def _raise(*args, **kwargs):
    raise RuntimeError("a profiler range was opened")


def test_off_path_calls_nothing(url, dat, monkeypatch):
    """Two sessions alike, one frame and one slider move each: the replies
    served while the profiler's range raises equal those served without."""
    plain, patched = _Viewer(url, dat), _Viewer(url, dat)
    try:
        want = [plain.frame(), plain.frame(alpha=7.0)]
        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                            _raise)
        got = [patched.frame(), patched.frame(alpha=7.0)]
        # The patch reaches what a span calls once a profiler runs.
        with _all_threads():
            with pytest.raises(RuntimeError, match="range was opened"):
                with span("lbm.frame"):
                    pass
    finally:
        plain.close()
        patched.close()
    assert got == want


def test_gate_reads_across_threads():
    """The span's gate, the module flag, reads True in a thread started
    before an all-threads profiler and False again after it; the
    thread-local test reads False there."""
    flags = torch.autograd.profiler
    start, done, seen = threading.Event(), threading.Event(), {}

    def thread():
        start.wait(timeout=30)
        seen["flag"] = flags._is_profiler_enabled
        seen["thread_local"] = torch.autograd._profiler_enabled()
        with span("thread span"):
            torch.ones(4).sum()
        done.set()

    t = threading.Thread(target=thread)
    t.start()
    assert not flags._is_profiler_enabled
    with _all_threads() as prof:
        start.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"flag": True, "thread_local": False}
    assert not flags._is_profiler_enabled
    (record,) = [e for e in prof.events() if e.name == "thread span"]
    # A host record alone: not a user annotation, which the profiler would
    # also draw over the device's kernels.
    assert not record.is_user_annotation


def test_graph_capture_span_names_its_program(monkeypatch):
    """A capture is spanned ``graphs.capture <program>`` (a CPU has no
    graphs: the capture's body is stubbed)."""
    called = []
    monkeypatch.setattr(graphs._Graph, "_capture",
                        lambda self, *a: called.append(a))
    with _all_threads() as prof:
        graphs._Graph().capture(("frame", ("cpu", 192, 384)), None, [],
                                False)
    assert len(called) == 1
    names = [e.name for e in prof.events()]
    assert names.count("graphs.capture frame") == 1


def test_span_exported():
    assert "span" in profiling.__all__ and profiling.span is span
    s = span("x")
    with s as entered:
        assert entered is s
    assert s._range is None
