"""The frame fields' base64 (``api.field_b64``, ``csrc/field_b64.cu``).

On the CPU: ``b64encode`` of CPU tensors is ``binascii.b2a_base64`` of
their bytes, as ``bytes``, and fields on two devices are refused.

On a CUDA card (marked ``card``; each skips inside itself without one, and
the file imports no JAX, so that it runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_field_b64.py``):

- the kernel equals ``binascii`` at 1, 2, 3, 11, 12, 13, 294,912 and
  8,388,608 bytes (n = 0, 1 and 2 mod 3), on random float32 payloads
  with NaN, +-inf, -0 and denormals, and on five fields in one launch of
  odd lengths at 4-byte-aligned addresses; each string is a
  ``memoryview`` slice of one pinned buffer, and each call is one launch
  (``field_b64.launches``); a field off a 4-byte boundary is refused;
- a served frame (minihttp on the card) at 384x192 (``speed,ux,uy``) and
  at 2048x1024 (``speed``) has the body that ``binascii`` gives from the
  same field tensors, byte for byte, and ``field_b64.launches`` advances
  by one a frame;
- two sessions' frames served at once on one card each carry their own
  fields.
"""

import binascii
import json
import threading
import urllib.parse
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from airfoil_tpu_torch.api import field_b64
from airfoil_tpu_torch.api.minihttp import make_server
from airfoil_tpu_torch.models import naca4

SIZES = (1, 2, 3, 11, 12, 13, 294_912, 8_388_608)


def _want(t: torch.Tensor) -> bytes:
    return binascii.b2a_base64(t.cpu().contiguous().numpy().tobytes(),
                               newline=False)


@pytest.mark.parametrize("n", (0, 1, 2, 3, 4, 11, 12, 13))
def test_cpu_tensors_take_binascii(n):
    g = torch.Generator().manual_seed(n)
    raw = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g)
    floats = torch.randn(n, 3, generator=g)
    got = field_b64.b64encode([raw, floats, floats.t()])
    assert [type(d) for d in got] == [bytes] * 3
    assert got == [_want(raw), _want(floats), _want(floats.t())]


def test_fields_on_two_devices_are_refused():
    with pytest.raises(ValueError, match="more than one device"):
        field_b64.b64encode([torch.zeros(3), torch.zeros(3, device="meta")])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encode kernel runs only there")
    return torch.device("cuda")


def _check(tensors):
    before = field_b64.launches
    got = field_b64.b64encode(tensors)
    torch.cuda.synchronize()
    assert field_b64.launches == before + 1
    assert all(isinstance(d, memoryview) for d in got)
    assert len({id(d.obj) for d in got}) == 1          # one pinned buffer
    for d, t in zip(got, tensors):
        assert d.format == "B" and d.c_contiguous
        assert bytes(d) == _want(t)


@pytest.mark.card
@pytest.mark.parametrize("n", SIZES)
def test_kernel_equals_binascii(card, n):
    g = torch.Generator(device=card).manual_seed(n)
    raw = torch.randint(0, 256, (n,), dtype=torch.uint8, device=card,
                        generator=g)
    _check([raw])


@pytest.mark.card
@pytest.mark.parametrize("shape", [(192, 384), (1024, 2048), (7,), (5, 3)])
def test_kernel_float_payloads(card, shape):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    t = torch.randn(shape, device=card, generator=g) * 1e3
    flat = t.view(-1)
    specials = torch.tensor([np.nan, np.inf, -np.inf, -0.0, 1e-45, -1e-40,
                             1.1754942e-38, 3.4028235e38], device=card)
    k = min(flat.numel(), specials.numel())
    flat[:k] = specials[:k]
    flat[-k:] = specials[:k]
    _check([t])


@pytest.mark.card
def test_kernel_five_fields_of_odd_lengths(card):
    g = torch.Generator(device=card).manual_seed(5)
    buf = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device=card,
                        generator=g)
    starts = (4, 4_100, 70_000, 300_004, 800_008)
    lengths = (13, 65_537, 11, 294_913, 200_002)
    _check([buf[s:s + n] for s, n in zip(starts, lengths)])
    _check([buf[s:s + n] for s, n in zip(starts, (0, 1, 2, 3, 12))])
    before = field_b64.launches
    with pytest.raises(ValueError, match="at most"):
        field_b64.b64encode([buf[:12]] * (field_b64.MAX_FIELDS + 1))
    for start in (1, 2, 3):
        with pytest.raises(RuntimeError, match="misaligned"):
            field_b64.b64encode([buf[:12], buf[start:start + 12]])
    assert field_b64.launches == before


def _multipart(fields: dict, name: str, content: bytes):
    boundary = uuid.uuid4().hex
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
             f"\r\n\r\n{v}\r\n".encode() for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="file"; filename="{name}"\r\n'
                 "Content-Type: application/octet-stream\r\n\r\n".encode()
                 + content + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _post(url, body: bytes, ctype: str) -> bytes:
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.status == 200
        out = r.read()
        assert int(r.headers["Content-Length"]) == len(out)
        return out


@pytest.fixture
def served(card, monkeypatch):
    """A minihttp server on the card, and the field tensors of each encode
    of its frames, as host copies taken before the encode."""
    seen: list[list] = []
    encode = field_b64.b64encode

    def recorded(tensors):
        seen.append([t.cpu() for t in tensors])
        return encode(tensors)

    monkeypatch.setattr(field_b64, "b64encode", recorded)
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device=card)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", seen
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _start(url, nx, alpha) -> str:
    dat = "\n".join(["NACA 2412"] + [f" {x:.6f} {y:.6f}" for x, y in
                                     naca4(2, 4, 12, 80)]).encode()
    body, ctype = _multipart({"alpha": alpha, "nx": nx}, "naca2412.dat", dat)
    return json.loads(_post(url + "/lbm/start", body, ctype))["session"]


def _frame(url, session, fields, alpha=None) -> bytes:
    form = {"session": session, "fields": fields}
    if alpha is not None:
        form["alpha"] = alpha
    return _post(url + "/lbm/frame",
                 urllib.parse.urlencode(form).encode(),
                 "application/x-www-form-urlencoded")


def _host_body(body: bytes, tensors) -> bytes:
    """The reply with each field's ``data`` replaced by ``binascii``'s
    base64 of the same field tensor, dumped as ``json.dumps`` writes it."""
    reply = json.loads(body)
    for field, t in zip(reply["fields"].values(), tensors):
        field["data"] = _want(t).decode()
    return json.dumps(reply).encode()


@pytest.mark.card
@pytest.mark.parametrize("nx,fields", [(384, "speed,ux,uy"), (2048, "speed")])
def test_served_frame_body_equals_binascii(served, nx, fields):
    url, seen = served
    session = _start(url, nx, 6.0)
    for alpha in (None, 8.0, None):
        count = field_b64.launches
        body = _frame(url, session, fields, alpha)
        assert field_b64.launches - count == 1
        (tensors,) = seen
        assert body == _host_body(body, tensors)
        assert list(json.loads(body)["fields"]) == fields.split(",")
        seen.clear()


@pytest.mark.card
def test_concurrent_sessions_get_their_own_fields(served):
    url, seen = served
    sessions = [_start(url, 384, a) for a in (2.0, 14.0)]
    bodies: dict[str, list] = {s: [] for s in sessions}
    errors = []
    count = field_b64.launches

    def viewer(session):
        try:
            for _ in range(12):
                bodies[session].append(
                    _frame(url, session, "speed,ux,uy"))
        except Exception as e:                     # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=viewer, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert field_b64.launches - count == 2 * 12
    # Every body carries the fields of exactly one encode, and no two
    # bodies the same one.
    records = [[_want(t).decode() for t in tensors] for tensors in seen]
    assert len(records) == 2 * 12
    matched = set()
    for session in sessions:
        for body in bodies[session]:
            data = [f["data"] for f in json.loads(body)["fields"].values()]
            hits = [k for k, r in enumerate(records) if r == data]
            assert len(hits) == 1, (session, hits)
            matched.add(hits[0])
    assert len(matched) == 2 * 12
    speed = [np.frombuffer(binascii.a2b_base64(
        json.loads(bodies[s][-1])["fields"]["speed"]["data"]), np.float32)
        for s in sessions]
    assert not np.array_equal(speed[0], speed[1], equal_nan=True)
