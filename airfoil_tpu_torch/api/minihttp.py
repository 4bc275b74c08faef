"""Dependency-free HTTP server for the port: the analyses and the
wind-tunnel service.

Port of ``airfoil_tpu/api/minihttp.py`` on the standard library's
``ThreadingHTTPServer``, with the same routes, per-IP rate limiter and
multipart/form-data parser. ``/upload_airfoil/``, ``/polar/`` and
``/batch/`` (N file parts named ``files``) solve on the server's device
under the ``solve`` rate limit and the solver lock; ``GET /stats`` reads
the analysis counter; ``/lbm/start`` takes an optional ``nx``
(``handlers.lbm_config``). A JSON reply leaves as one gather write
(``socket.sendmsg``) of its header block and ``handlers.reply_parts``,
straight from the buffers the parts live in, with no join; where the
socket has no ``sendmsg``, each part is written in turn. ``gather_writes``
counts the replies written by ``sendmsg``. A request is traced as
``utils.profiling.span``s: ``http <route>`` (``http other`` for an
unknown path) around ``http.read``, ``http.encode``
(``handlers.reply_parts``) and ``http.write`` (the headers and the
gather write). ``serve`` starts ``handlers.start_warmup`` (the kernel
libraries and the solver's CUDA graphs, in a background thread), as the
reference's does. The page at ``/app`` is the port's byte copy of the
reference's ``ui/static_app.html``.

Run: ``python -m airfoil_tpu_torch.api.minihttp`` (port from ``$PORT``,
device from ``$AIRFOIL_TPU_TORCH_DEVICE``, default ``cuda``).
"""

from __future__ import annotations

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
from airfoil_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

__all__ = ["serve", "make_server"]

_ROUTES = ("/", "/health", "/stats", "/app", "/app/", "/upload_airfoil/",
           "/polar/", "/batch/", "/lbm/start", "/lbm/frame", "/lbm/stop")
_SPANS = {route: f"http {route}" for route in _ROUTES}

# The replies written by one gather write (``_write_parts``), under a lock:
# the server is threaded.
gather_writes = 0
_GATHER_LOCK = threading.Lock()
# The buffers one ``sendmsg`` takes at most (Linux's IOV_MAX).
_IOV_MAX = 1024

_STATIC_APP = os.path.join(os.path.dirname(os.path.dirname(__file__)), "ui",
                           "static_app.html")


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


def _write_parts(connection, wfile, parts):
    """Write ``parts`` (bytes-like, flat) in order: by ``sendmsg`` on
    ``connection``, resumed over a partial send by slicing a memoryview of
    the part it stopped in, and counted in ``gather_writes``; where the
    connection has no ``sendmsg``, by ``wfile.write`` a part. Neither way
    joins or copies a part."""
    global gather_writes
    sendmsg = getattr(connection, "sendmsg", None)
    if sendmsg is None:
        for part in parts:
            wfile.write(part)
        return
    # Counted before the bytes go: a client that has the reply sees it.
    with _GATHER_LOCK:
        gather_writes += 1
    parts, i = list(parts), 0
    while i < len(parts):
        sent = sendmsg(parts[i:i + _IOV_MAX])
        while i < len(parts) and sent >= len(parts[i]):
            sent -= len(parts[i])
            i += 1
        if sent:
            parts[i] = memoryview(parts[i])[sent:]


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
            with span("http.encode"):
                parts = handlers.reply_parts(payload)
            with span("http.write"):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length",
                                 str(sum(map(len, parts))))
                self.send_header("Access-Control-Allow-Origin", "*")
                _write_parts(self.connection, self.wfile,
                             [self._header_block(), *parts])

        def _header_block(self) -> bytes:
            """The buffered status line and headers with the blank line
            that ends them, as ``end_headers`` would flush them (none on
            HTTP/0.9); the buffer is emptied."""
            if self.request_version != "HTTP/0.9":
                self._headers_buffer.append(b"\r\n")
            head = b"".join(getattr(self, "_headers_buffer", ()))
            self._headers_buffer = []
            return head

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

        def _body(self):
            length = int(self.headers.get("Content-Length", "0"))
            if length > config.MAX_FILE_SIZE + 1_000_000:
                raise ApiError(400, "Request too large")
            return self.rfile.read(length)

        def _form(self):
            with span("http.read"):
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

        @staticmethod
        def _all_files(files):
            """Every uploaded file part, preferring the repeated "files"
            convention; else any field names (e.g. file0..fileN) in sorted
            order."""
            if files.get("files"):
                return list(files["files"])
            return [pair for k in sorted(files) for pair in files[k]]

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
            with span(_SPANS.get(path, "http other")):
                self._get(path)

        def _get(self, path: str):
            try:
                if path == "/":
                    if self._limited("root"):
                        return
                    self._send_json(*handlers.handle_root())
                elif path == "/health":
                    if self._limited("health"):
                        return
                    self._send_json(*handlers.handle_health(sessions.device))
                elif path == "/stats":
                    self._send_json(*handlers.handle_stats())
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
            with span(_SPANS.get(path, "http other")):
                self._post(path)

        def _post(self, path: str):
            try:
                if path in ("/upload_airfoil/", "/polar/", "/batch/",
                            "/lbm/start") and self._limited("solve"):
                    return
                fields, files = self._form()
                if path == "/upload_airfoil/":
                    name, content = self._file_field(files)
                    with solver_lock:
                        out = handlers.handle_upload(
                            name, content, _f(fields, "reynolds"),
                            _f(fields, "alpha"), device=sessions.device)
                elif path == "/polar/":
                    name, content = self._file_field(files)
                    with solver_lock:
                        out = handlers.handle_polar(
                            name, content, _f(fields, "reynolds"),
                            _f(fields, "alpha_start"),
                            _f(fields, "alpha_end"),
                            _f(fields, "alpha_step", 1.0),
                            device=sessions.device)
                elif path == "/batch/":
                    pairs = self._all_files(files)
                    with solver_lock:
                        out = handlers.handle_batch(
                            pairs, _f(fields, "reynolds"),
                            _f(fields, "alpha"), device=sessions.device)
                elif path == "/lbm/start":
                    name, content = self._file_field(files)
                    with solver_lock:
                        out = sessions.start(
                            name, content, _f(fields, "alpha", 6.0),
                            fields.get("nx"))
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
    handlers.start_warmup(device)
    logger.info("airfoil_tpu_torch mini server on %s:%d (device %s)",
                *httpd.server_address, device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    serve()
