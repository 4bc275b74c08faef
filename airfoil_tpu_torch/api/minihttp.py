"""Dependency-free HTTP server for the port: the single-point analysis
and the wind-tunnel service.

Port of ``airfoil_tpu/api/minihttp.py`` on the standard library's
``ThreadingHTTPServer``, with the same routes, per-IP rate limiter and
multipart/form-data parser. ``/upload_airfoil/`` runs ``analyze_airfoil``
on the server's device under the ``solve`` rate limit and the solver
lock. It compiles nothing at start-up: the reference's ``start_warmup``
warms XLA compiles, which the port does not have (its CUDA libraries build
at first use). The routes whose solvers are not ported yet (``/polar/``,
``/batch/`` and ``/stats``) answer 501. The page at ``/app`` is the port's
byte copy of the reference's ``ui/static_app.html``.

Run: ``python -m airfoil_tpu_torch.api.minihttp`` (port from ``$PORT``,
device from ``$AIRFOIL_TPU_TORCH_DEVICE``, default ``cuda``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from airfoil_tpu_torch import config
from airfoil_tpu_torch.api import handlers
from airfoil_tpu_torch.api.handlers import ApiError, LBMSessions
from airfoil_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["serve", "make_server", "NOT_PORTED"]

_STATIC_APP = os.path.join(os.path.dirname(os.path.dirname(__file__)), "ui",
                           "static_app.html")
NOT_PORTED = ("/polar/", "/batch/", "/stats")


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser: returns (fields, files).

    ``fields``: dict of str -> str; ``files``: dict of field name ->
    LIST of (filename, bytes); repeated file field names accumulate.
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ApiError(400, "Malformed multipart request (no boundary)")
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, str] = {}
    files: dict[str, list[tuple[str, bytes]]] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        head_text = head.decode("utf-8", errors="ignore")
        name_m = re.search(r'name="([^"]+)"', head_text)
        if not name_m:
            continue
        name = name_m.group(1)
        file_m = re.search(r'filename="([^"]*)"', head_text)
        if file_m:
            files.setdefault(name, []).append((file_m.group(1), payload))
        else:
            fields[name] = payload.decode("utf-8", errors="ignore")
    return fields, files


def _f(fields, key, default=None):
    v = fields.get(key)
    if v is None or v == "":
        if default is not None:
            return default
        raise ApiError(400, f"Missing form field '{key}'")
    try:
        return float(v)
    except ValueError:
        raise ApiError(400, f"Field '{key}' must be a number")


class _RateLimiter:
    """Per-(IP, route-class) sliding-window limiter: root 10/min, health
    20/min, solver posts 5/min. LBM frame/stop posts are exempt — they
    stream at interactive rates."""

    LIMITS = {"root": 10, "health": 20, "solve": 5}

    def __init__(self, window: float = 60.0):
        self._window = window
        self._lock = threading.Lock()
        self._hits: dict[tuple[str, str], deque] = {}

    def allow(self, ip: str, kind: str) -> bool:
        limit = self.LIMITS.get(kind)
        if limit is None:
            return True
        now = time.monotonic()
        with self._lock:
            q = self._hits.setdefault((ip, kind), deque())
            while q and now - q[0] > self._window:
                q.popleft()
            if len(q) >= limit:
                return False
            q.append(now)
            return True


def make_server(host: str = "0.0.0.0", port: int | None = None,
                rate_limit: bool = True, device=None):
    """A ``ThreadingHTTPServer`` serving analyses and wind-tunnel sessions
    on ``device`` (resolved by ``device.resolve_device``; raises for
    ``cuda`` without a CUDA device)."""
    port = config.PORT if port is None else port
    sessions = LBMSessions(device=device)
    solver_lock = threading.Semaphore(config.MAX_CONCURRENT_SOLVES)
    limiter = _RateLimiter() if rate_limit else None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s " + fmt, self.address_string(), *args)

        # ── plumbing ────────────────────────────────────────────────────
        def _send_json(self, status: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def _send_file(self, path: str, ctype: str):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                self._send_json(404, {"detail": "not found"})
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _not_ported(self, path: str):
            self._send_json(501, {"detail": f"{path} not yet ported to "
                                            f"airfoil_tpu_torch"})

        def _body(self):
            length = int(self.headers.get("Content-Length", "0"))
            if length > config.MAX_FILE_SIZE + 1_000_000:
                raise ApiError(400, "Request too large")
            return self.rfile.read(length)

        def _form(self):
            ctype = self.headers.get("Content-Type", "")
            body = self._body()
            if ctype.startswith("multipart/form-data"):
                return _parse_multipart(body, ctype)
            if ctype.startswith("application/x-www-form-urlencoded"):
                qs = parse_qs(body.decode())
                return {k: v[0] for k, v in qs.items()}, {}
            raise ApiError(400, f"Unsupported content type: {ctype}")

        def _file_field(self, files, name="file"):
            if not files.get(name):
                raise ApiError(400, f"Missing file field '{name}'")
            return files[name][0]

        def _limited(self, kind: str) -> bool:
            """True (and responds 429) when the rate limit is exhausted."""
            if limiter is None:
                return False
            ip = self.client_address[0]
            if limiter.allow(ip, kind):
                return False
            self._send_json(429, {"detail": "Rate limit exceeded"})
            return True

        # ── routes ──────────────────────────────────────────────────────
        def do_GET(self):
            path = urlparse(self.path).path
            try:
                if path == "/":
                    if self._limited("root"):
                        return
                    self._send_json(*handlers.handle_root())
                elif path == "/health":
                    if self._limited("health"):
                        return
                    self._send_json(*handlers.handle_health(sessions.device))
                elif path in NOT_PORTED:
                    self._not_ported(path)
                elif path in ("/app", "/app/"):
                    self._send_file(_STATIC_APP, "text/html; charset=utf-8")
                else:
                    self._send_json(404, {"detail": "not found"})
            except ApiError as e:
                self._send_json(e.status_code, {"detail": e.detail})
            except Exception as e:  # pragma: no cover
                logger.exception("GET %s failed", path)
                self._send_json(500, {"detail": str(e)})

        def do_HEAD(self):
            path = urlparse(self.path).path
            status = 200 if path in ("/", "/health") else 404
            self.send_response(status)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, HEAD, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_POST(self):
            path = urlparse(self.path).path
            try:
                if path in NOT_PORTED:
                    self._body()  # drain, so the connection stays usable
                    self._not_ported(path)
                    return
                if path in ("/upload_airfoil/", "/lbm/start") \
                        and self._limited("solve"):
                    return
                fields, files = self._form()
                if path == "/upload_airfoil/":
                    name, content = self._file_field(files)
                    with solver_lock:
                        out = handlers.handle_upload(
                            name, content, _f(fields, "reynolds"),
                            _f(fields, "alpha"), device=sessions.device)
                elif path == "/lbm/start":
                    name, content = self._file_field(files)
                    with solver_lock:
                        out = sessions.start(name, content,
                                             _f(fields, "alpha", 6.0))
                elif path == "/lbm/frame":
                    alpha = fields.get("alpha")
                    u0 = fields.get("u0")
                    out = sessions.frame(
                        fields.get("session", ""),
                        float(alpha) if alpha not in (None, "") else None,
                        float(u0) if u0 not in (None, "") else None,
                        fields.get("fields", "speed"))
                elif path == "/lbm/stop":
                    out = sessions.stop(fields.get("session", ""))
                else:
                    out = (404, {"detail": "not found"})
                self._send_json(*out)
            except ApiError as e:
                self._send_json(e.status_code, {"detail": e.detail})
            except Exception as e:  # pragma: no cover
                logger.exception("POST %s failed", path)
                self._send_json(500, {"detail": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def serve(host: str = "0.0.0.0", port: int | None = None, device=None):
    device = resolve_device(device)
    httpd = make_server(host, port, device=device)
    logger.info("airfoil_tpu_torch mini server on %s:%d (device %s)",
                *httpd.server_address, device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    serve()
