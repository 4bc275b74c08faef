"""The reply's bytes (``api.handlers.encode_reply``) on the CPU.

A frame's fields carry their base64 as ASCII ``bytes``, and
``encode_reply`` joins them into the dumped rest of the reply: the body
equals ``json.dumps(...).encode()`` of the same payload with each field's
``data`` the str ``base64.b64encode`` gives of its float32 buffer (the
reply as it was written before), byte for byte, with solid cells (NaN)
in the fields and NaN in the scalars. Every other reply (root, health,
stats, an error, a polar's rows) is plain ``json.dumps(...).encode()``;
what ``json.dumps`` refuses, or a str that is the bytes' stand-in, raises.
Served by minihttp, a frame's ``Content-Length`` is its body's, its
fields decode to ``render_fields`` of the session's lattice, it passes
through ``LBMSessions.frame``, and ``raw_field_replies`` counts one a
frame and none for ``/health``.
"""

import base64
import copy
import json
import math
import threading

import numpy as np
import pytest
import requests
import torch

from airfoil_tpu_torch.api import handlers
from airfoil_tpu_torch.api.handlers import LBMSessions, encode_reply
from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.lbm.diagnostics import render_fields
from airfoil_tpu_torch.models import naca4

FIELD_NAMES = ("speed", "cp", "vorticity", "ux", "uy")


@pytest.fixture(scope="module")
def dat():
    return "\n".join(["NACA 2412"] + [f" {x:.6f} {y:.6f}" for x, y in
                                      naca4(2, 4, 12, 60)]).encode()


@pytest.fixture(scope="module")
def sessions():
    return LBMSessions(device="cpu")


def _rendered(sessions, session) -> dict:
    """The session's fields as ``render_fields`` gives them, float32
    arrays by name."""
    st = sessions._tunnels[session].state
    return {name: np.asarray(t, np.float32) for name, t in
            zip(FIELD_NAMES, render_fields(st.f, st.solid, st.u0))}


def _frame(sessions, dat, fields):
    """A frame of a new session, and the payload as the reply was written
    before: each field's ``data`` the base64 str of its rendered buffer."""
    _, meta = sessions.start("naca2412.dat", dat, 6.0)
    _, payload = sessions.frame(meta["session"], fields=fields)
    rendered = _rendered(sessions, meta["session"])
    sessions.stop(meta["session"])
    before = copy.deepcopy(payload)
    for name, field in before["fields"].items():
        assert isinstance(field["data"], bytes)
        assert np.isnan(rendered[name]).any()          # solid cells
        field["data"] = base64.b64encode(rendered[name].tobytes()).decode()
    return payload, before


def _nan_scalars(payload):
    payload = dict(payload, cl=math.nan, cd=math.inf)
    return payload, dict(payload, fields={
        k: dict(v, data=v["data"].decode()) for k, v in
        payload["fields"].items()})


POLAR_ROWS = [{"alpha": a, "cl": 0.1 * a, "cd": cd,
               "converged": cd is not None, "cp": [0.5, -1.25, math.nan]}
              for a, cd in ((-2.0, 0.0071), (0.0, None), (2.0, math.nan))]

CASES = {
    "frame_speed": lambda s, d: _frame(s, d, "speed"),
    "frame_speed_ux_uy": lambda s, d: _frame(s, d, "speed,ux,uy"),
    "frame_all_fields": lambda s, d: _frame(s, d, ",".join(FIELD_NAMES)),
    "frame_nan_scalars": lambda s, d: _nan_scalars(
        _frame(s, d, "speed,ux,uy")[0]),
    "root": lambda s, d: (handlers.handle_root()[1],) * 2,
    "health": lambda s, d: (handlers.handle_health(s.device)[1],) * 2,
    "stats": lambda s, d: ({"total_analyses": 12},) * 2,
    "error": lambda s, d: ({"detail": "Unknown session"},) * 2,
    "polar_rows": lambda s, d: ({"success": True, "reynolds": 1e6,
                                 "results": POLAR_ROWS},) * 2,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reply_bytes_equal_json_dumps(case, sessions, dat):
    payload, before = CASES[case](sessions, dat)
    want = json.dumps(before).encode()
    count = handlers.raw_field_replies
    assert encode_reply(payload) == want
    assert handlers.raw_field_replies - count == case.startswith("frame")


@pytest.mark.parametrize("payload,error", [
    ({"cl": np.float32(0.5), "data": b"AAAA"}, TypeError),
    ({"cl": 0.5, "data": b"AAAA"}, None),
    ({"note": "\0", "data": b"AAAA"}, ValueError),
    ({"note": "\0"}, None),
], ids=["not_json", "raw", "str_is_the_stand_in", "str_without_raw"])
def test_reply_refuses(payload, error):
    """What ``json.dumps`` refuses, and a str that is the stand-in of a
    reply's bytes (no reply has one), raise; without them the body is the
    dump's."""
    text = {k: v.decode() if isinstance(v, bytes) else v
            for k, v in payload.items()}
    if error is None:
        assert encode_reply(payload) == json.dumps(text).encode()
    else:
        with pytest.raises(error):
            encode_reply(payload)


@pytest.fixture
def served(monkeypatch):
    """A minihttp server on the CPU, with the ``LBMSessions`` whose
    ``frame`` it called and how often."""
    calls = []
    frame = LBMSessions.frame

    def recorded(self, *args, **kwargs):
        calls.append(self)
        return frame(self, *args, **kwargs)

    monkeypatch.setattr(LBMSessions, "frame", recorded)
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", calls
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def test_served_frame_reply(served, dat):
    url, calls = served
    conn = requests.Session()
    r = conn.post(url + "/lbm/start", data={"alpha": 6.0},
                  files={"file": ("naca2412.dat", dat)}, timeout=120)
    assert r.status_code == 200, r.text
    session = r.json()["session"]
    for k, alpha in enumerate((None, 8.0)):
        count = handlers.raw_field_replies
        form = {"session": session, "fields": "speed,ux,uy"}
        if alpha is not None:
            form["alpha"] = alpha
        r = conn.post(url + "/lbm/frame", data=form, timeout=120)
        assert r.status_code == 200, r.text
        assert handlers.raw_field_replies - count == 1
        assert len(calls) == k + 1
        assert r.headers["Content-Type"] == "application/json"
        assert int(r.headers["Content-Length"]) == len(r.content)
        assert json.dumps(r.json()).encode() == r.content
        want = _rendered(calls[-1], session)
        frame = r.json()
        assert set(frame["fields"]) == {"speed", "ux", "uy"}
        for name, field in frame["fields"].items():
            got = np.frombuffer(base64.b64decode(field["data"]), np.float32)
            assert field["shape"] == list(want[name].shape)
            np.testing.assert_array_equal(got.reshape(field["shape"]),
                                          want[name], err_msg=name)
    count = handlers.raw_field_replies
    r = conn.get(url + "/health", timeout=120)
    assert r.status_code == 200
    assert int(r.headers["Content-Length"]) == len(r.content)
    assert r.content == json.dumps(
        handlers.handle_health(torch.device("cpu"))[1]).encode()
    assert handlers.raw_field_replies == count
    conn.close()
