"""The reply's bytes (``api.handlers.reply_parts``, and minihttp's gather
write of them) on the CPU.

A frame's fields carry their base64 as ASCII ``bytes``, and
``reply_parts`` puts them, unjoined and uncopied, between the pieces of
the dumped rest of the reply: the parts joined equal
``json.dumps(...).encode()`` of the same payload with each field's
``data`` the str ``base64.b64encode`` gives of its float32 buffer (the
reply as it was written before), byte for byte, with solid cells (NaN)
in the fields and NaN in the scalars. The same holds where each ``data``
is a ``memoryview`` slice of one buffer, as a CUDA session's frame gives
them. Every other reply (root, health, stats, an error, a polar's rows)
is plain ``json.dumps(...).encode()``; what ``json.dumps`` refuses (a
memoryview that is not contiguous or not of bytes too), or a str that is
the bytes' stand-in, raises. Served by minihttp, a frame's
``Content-Length`` is its body's, its fields decode to ``render_fields``
of the session's lattice, it passes through ``LBMSessions.frame``, and a
CPU session launches no encode kernel (``field_b64.launches``). On the
wire, read by a raw socket, every reply (a frame with ``bytes`` or
memoryview leaves, replies without raw leaves, errors) is the status
line, headers and body the joined path wrote, byte for byte, one
``minihttp.gather_writes`` a reply; a ``sendmsg`` that sends a few bytes a
call, and a connection without ``sendmsg``, write the same bytes.
"""

import base64
import copy
import io
import json
import math
import socket
import threading
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler

import numpy as np
import pytest
import requests
import torch

from airfoil_tpu_torch.api import field_b64, handlers, minihttp
from airfoil_tpu_torch.api.handlers import LBMSessions, reply_parts
from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.lbm.diagnostics import render_fields
from airfoil_tpu_torch.models import naca4

FIELD_NAMES = ("speed", "cp", "vorticity", "ux", "uy")


def _joined(payload) -> bytes:
    """The reply's body: its parts joined."""
    return b"".join(reply_parts(payload))


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


def _as_views(payloads):
    """The frame with each field's ``data`` a ``memoryview`` slice of one
    buffer that holds every field's ASCII at 16-byte offsets."""
    payload, before = payloads
    fields = payload["fields"]
    offsets, total = [], 0
    for field in fields.values():
        offsets.append(total)
        total += (len(field["data"]) + 15) & ~15
    buf = bytearray(b"#" * total)
    for o, field in zip(offsets, fields.values()):
        buf[o:o + len(field["data"])] = field["data"]
    view = memoryview(buf)
    return dict(payload, fields={
        k: dict(v, data=view[o:o + len(v["data"])])
        for o, (k, v) in zip(offsets, fields.items())}), before


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
    "frame_speed_views": lambda s, d: _as_views(_frame(s, d, "speed")),
    "frame_speed_ux_uy_views": lambda s, d: _as_views(
        _frame(s, d, "speed,ux,uy")),
    "frame_all_fields_views": lambda s, d: _as_views(
        _frame(s, d, ",".join(FIELD_NAMES))),
    "root": lambda s, d: (handlers.handle_root()[1],) * 2,
    "health": lambda s, d: (handlers.handle_health(s.device)[1],) * 2,
    "stats": lambda s, d: ({"total_analyses": 12},) * 2,
    "error": lambda s, d: ({"detail": "Unknown session"},) * 2,
    "polar_rows": lambda s, d: ({"success": True, "reynolds": 1e6,
                                 "results": POLAR_ROWS},) * 2,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reply_bytes_equal_json_dumps(case, sessions, dat):
    on_card = field_b64.launches
    payload, before = CASES[case](sessions, dat)
    want = json.dumps(before).encode()
    assert _joined(payload) == want
    assert field_b64.launches == on_card


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                         if c.startswith("frame")))
def test_reply_parts_are_the_leaves(case, sessions, dat):
    """Between the dumped pieces, each with its quotes, the parts are the
    fields' own ``bytes``, or flat views of the same memory: no leaf is
    joined or copied."""
    payload, _ = CASES[case](sessions, dat)
    parts = reply_parts(payload)
    leaves = [f["data"] for f in payload["fields"].values()]
    assert len(parts) == 2 * len(leaves) + 1
    for leaf, part in zip(leaves, parts[1::2]):
        if isinstance(leaf, bytes):
            assert part is leaf
        else:
            assert isinstance(part, memoryview) and part.obj is leaf.obj
            assert part.nbytes == leaf.nbytes and part.ndim == 1
            assert np.shares_memory(np.asarray(part), np.asarray(leaf))
    for piece in parts[::2]:
        assert isinstance(piece, bytes)
    assert all(p.endswith(b'"') for p in parts[:-1:2])
    assert all(p.startswith(b'"') for p in parts[2::2])


@pytest.mark.parametrize("payload,error", [
    ({"cl": np.float32(0.5), "data": b"AAAA"}, TypeError),
    ({"cl": 0.5, "data": b"AAAA"}, None),
    ({"note": "\0", "data": b"AAAA"}, ValueError),
    ({"note": "\0"}, None),
    ({"cl": 0.5, "data": memoryview(b"#AAAA#")[1:5]}, None),
    ({"cl": 0.5, "data": memoryview(b"AxAxAxAx")[::2]}, TypeError),
    ({"cl": 0.5, "data": memoryview(b"AAAA").cast("I")}, TypeError),
    ({"note": "\0", "data": memoryview(b"AAAA")}, ValueError),
], ids=["not_json", "raw", "str_is_the_stand_in", "str_without_raw",
        "view", "view_not_contiguous", "view_not_bytes",
        "str_is_the_stand_in_of_a_view"])
def test_reply_refuses(payload, error):
    """What ``json.dumps`` refuses (a memoryview that is not contiguous or
    not of format ``B`` too), and a str that is the stand-in of a reply's
    bytes (no reply has one), raise; without them the body is the dump's."""
    text = {k: bytes(v).decode() if isinstance(v, (bytes, memoryview))
            else v for k, v in payload.items()}
    if error is None:
        assert _joined(payload) == json.dumps(text).encode()
    else:
        with pytest.raises(error):
            _joined(payload)


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
    on_card = field_b64.launches
    for k, alpha in enumerate((None, 8.0)):
        form = {"session": session, "fields": "speed,ux,uy"}
        if alpha is not None:
            form["alpha"] = alpha
        r = conn.post(url + "/lbm/frame", data=form, timeout=120)
        assert r.status_code == 200, r.text
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
    r = conn.get(url + "/health", timeout=120)
    assert r.status_code == 200
    assert int(r.headers["Content-Length"]) == len(r.content)
    assert r.content == json.dumps(
        handlers.handle_health(torch.device("cpu"))[1]).encode()
    assert field_b64.launches == on_card
    conn.close()


# ── the reply on the wire ─────────────────────────────────────────────────

DATE = "Thu, 01 Jan 2026 00:00:00 GMT"


def _wire(status: int, body: bytes) -> bytes:
    """A JSON reply as the joined path wrote it: the status line, the
    headers ``send_response`` and ``_send_json`` send, the blank line and
    the body."""
    server = (f"{BaseHTTPRequestHandler.server_version} "
              f"{BaseHTTPRequestHandler.sys_version}")
    return (f"HTTP/1.1 {status} {HTTPStatus(status).phrase}\r\n"
            f"Server: {server}\r\nDate: {DATE}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Access-Control-Allow-Origin: *\r\n\r\n").encode() + body


def _request(method: str, path: str, form: str | None = None,
             ctype: str = "application/x-www-form-urlencoded",
             close: bool = False) -> bytes:
    head = f"{method} {path} HTTP/1.1\r\nHost: test\r\n"
    if close:
        head += "Connection: close\r\n"
    if form is None:
        return (head + "\r\n").encode()
    return (head + f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(form)}\r\n\r\n{form}").encode()


@pytest.fixture
def wire(monkeypatch, sessions, dat):
    """A minihttp server on the CPU whose ``/lbm/frame`` answers the canned
    frames ``frame_bytes`` and ``frame_views`` by session name (else the
    real ``LBMSessions.frame``), with a fixed ``Date``; returns a function
    that sends raw requests on one connection and reads every byte until
    the server closes it, and the canned frames as the joined path's
    payloads."""
    canned = {"frame_bytes": _frame(sessions, dat, "speed,ux,uy"),
              "frame_views": _as_views(_frame(sessions, dat, "speed,ux,uy"))}
    frame = LBMSessions.frame

    def answer(self, session, *args, **kwargs):
        if session in canned:
            return 200, canned[session][0]
        return frame(self, session, *args, **kwargs)

    monkeypatch.setattr(LBMSessions, "frame", answer)
    monkeypatch.setattr(BaseHTTPRequestHandler, "date_time_string",
                        lambda self, timestamp=None: DATE)
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def exchange(*requests_) -> bytes:
        with socket.create_connection(httpd.server_address, timeout=60) as c:
            c.sendall(b"".join(requests_))
            got = bytearray()
            while chunk := c.recv(1 << 16):
                got += chunk
        return bytes(got)

    yield exchange, {k: v[1] for k, v in canned.items()}
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


WIRE_CASES = {
    "frame_bytes": lambda want: (
        ("POST", "/lbm/frame", "session=frame_bytes"),
        (200, want["frame_bytes"])),
    "frame_views": lambda want: (
        ("POST", "/lbm/frame", "session=frame_views"),
        (200, want["frame_views"])),
    "health": lambda want: (
        ("GET", "/health", None),
        handlers.handle_health(torch.device("cpu"))),
    "stop": lambda want: (
        ("POST", "/lbm/stop", "session=gone"), (200, {"stopped": "gone"})),
    "unknown_session": lambda want: (
        ("POST", "/lbm/frame", "session=nobody"),
        (404, {"detail": "Unknown session"})),
    "unknown_route": lambda want: (
        ("GET", "/nowhere", None), (404, {"detail": "not found"})),
    "bad_form": lambda want: (
        ("POST", "/lbm/frame", "session=x", "text/plain"),
        (400, {"detail": "Unsupported content type: text/plain"})),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_bytes_equal_joined_path(case, wire):
    """Each reply, read from a raw socket to the server's close, is the
    status line, headers and body the joined path wrote, and one gather
    write."""
    exchange, want = wire
    request, (status, payload) = WIRE_CASES[case](want)
    before = minihttp.gather_writes
    got = exchange(_request(*request, close=True))
    assert got == _wire(status, json.dumps(payload).encode())
    assert minihttp.gather_writes == before + 1


def test_wire_keep_alive(wire):
    """Every case in turn on one kept-alive connection: the replies follow
    one another with not a byte between or after them, one gather write
    each."""
    exchange, want = wire
    cases = [WIRE_CASES[c](want) for c in sorted(WIRE_CASES)]
    before = minihttp.gather_writes
    got = exchange(*(_request(*r) for r, _ in cases),
                   _request("GET", "/nowhere", close=True))
    assert got == b"".join(
        [_wire(s, json.dumps(p).encode()) for _, (s, p) in cases]
        + [_wire(404, b'{"detail": "not found"}')])
    assert minihttp.gather_writes == before + len(cases) + 1


class _Trickle:
    """A connection whose ``sendmsg`` takes at most ``step`` bytes a call,
    in order across the buffers, and at most ``minihttp._IOV_MAX``
    buffers."""

    def __init__(self, step: int):
        self.step, self.got, self.calls = step, bytearray(), 0

    def sendmsg(self, buffers):
        assert 0 < len(buffers) <= minihttp._IOV_MAX
        self.calls += 1
        room = self.step
        for b in buffers:
            take = bytes(memoryview(b)[:room])
            self.got += take
            room -= len(take)
            if not room:
                break
        return self.step - room


class _NoSendmsg:
    """A connection without ``sendmsg``."""


def _parts(case, sessions, dat) -> tuple[list, bytes]:
    """A header block and the case's reply parts, and their bytes."""
    payload, before = (CASES[case](sessions, dat) if case in CASES else
                       ({f"k{i}": b"AAAA" for i in range(1500)},) * 2)
    head = b"HTTP/1.1 200 OK\r\nContent-Length: 1\r\n\r\n"
    text = {k: bytes(v).decode() if isinstance(v, (bytes, memoryview))
            else v for k, v in before.items()}
    return [head, *reply_parts(payload)], head + json.dumps(text).encode()


@pytest.mark.parametrize("step", [1, 7, 4096, 1 << 30])
@pytest.mark.parametrize("case", ["frame_speed_ux_uy_views",
                                  "frame_all_fields", "root",
                                  "many_leaves"])
def test_gather_write_resumes_a_partial_send(case, step, sessions, dat):
    """A ``sendmsg`` that stops a few bytes in, inside any part, is resumed
    where it stopped; more parts than one call takes go in turns."""
    parts, want = _parts(case, sessions, dat)
    conn = _Trickle(step)
    before = minihttp.gather_writes
    minihttp._write_parts(conn, None, parts)
    assert bytes(conn.got) == want
    assert conn.calls >= -(-len(want) // step)
    assert minihttp.gather_writes == before + 1


@pytest.mark.parametrize("case", ["frame_speed_ux_uy_views",
                                  "frame_all_fields", "root"])
def test_write_without_sendmsg(case, sessions, dat):
    """Without ``sendmsg`` each part goes to ``wfile`` in turn, the same
    bytes, and no gather write is counted."""
    parts, want = _parts(case, sessions, dat)
    wfile = io.BytesIO()
    before = minihttp.gather_writes
    minihttp._write_parts(_NoSendmsg(), wfile, parts)
    assert wfile.getvalue() == want
    assert minihttp.gather_writes == before


def test_gather_writes_counts_every_thread():
    """Replies written from more threads than cores, switching often: the
    count loses none, and each connection gets its own bytes whole."""
    import os
    import sys

    parts = [b"HTTP/1.1 200 OK\r\n\r\n", *reply_parts(
        {"a": memoryview(b"#QUFB#")[1:5], "b": b"QkJC", "n": 1})]
    want = b"".join(parts)
    n_threads, n_writes = 2 * (os.cpu_count() or 1) + 2, 200
    conns = [_Trickle(3) for _ in range(n_threads)]

    def write(conn):
        for _ in range(n_writes):
            minihttp._write_parts(conn, None, parts)

    before, interval = minihttp.gather_writes, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(c,)) for c in conns]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert minihttp.gather_writes == before + n_threads * n_writes
    assert all(bytes(c.got) == want * n_writes for c in conns)


def test_wire_http09(wire):
    """An HTTP/0.9 request gets the body alone, as the joined path wrote
    it: no status line and no headers."""
    exchange, _ = wire
    before = minihttp.gather_writes
    assert exchange(b"GET /nowhere\r\n\r\n") == b'{"detail": "not found"}'
    assert minihttp.gather_writes == before + 1
