"""Test doubles of ``fastapi`` (with ``fastapi.middleware.cors``) and
``slowapi``, which the CPU test machine does not install (``chip_smoke.py``
phase 32 serves the real FastAPI where it is installed).

They record what ``api/server.py`` asks of them: every route (method,
path, its coroutine and the slowapi limit wrapped round it), the startup
hooks, the middleware with its options and the exception handlers;
``Form(default)`` returns a ``FormDefault`` holding its default;
``HTTPException`` carries ``status_code`` and ``detail``; ``UploadFile``
holds a file name and bytes; ``Response`` holds its body and media type.
``modules()`` gives them by module name, for ``sys.modules``.
"""

from __future__ import annotations

import types


class HTTPException(Exception):
    def __init__(self, status_code: int, detail=None):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


class UploadFile:
    def __init__(self, filename: str, content: bytes):
        self.filename = filename
        self._content = content

    async def read(self) -> bytes:
        return self._content


class Request:
    pass


class Response:
    def __init__(self, content: bytes = b"", media_type: str | None = None):
        self.body = content
        self.media_type = media_type


class FormDefault:
    def __init__(self, default):
        self.default = default


def Form(default=...):                                    # noqa: N802
    return FormDefault(default)


class CORSMiddleware:
    pass


class FastAPI:
    def __init__(self, title: str = "", **kwargs):
        self.title = title
        self.routes: list[tuple[str, str, object]] = []
        self.events: dict[str, list] = {}
        self.middleware: list[tuple[type, dict]] = []
        self.exception_handlers: dict = {}
        self.state = types.SimpleNamespace()

    def _route(self, method: str, path: str):
        def deco(fn):
            self.routes.append((method, path, fn))
            return fn
        return deco

    def get(self, path: str):
        return self._route("GET", path)

    def head(self, path: str):
        return self._route("HEAD", path)

    def post(self, path: str):
        return self._route("POST", path)

    def on_event(self, name: str):
        def deco(fn):
            self.events.setdefault(name, []).append(fn)
            return fn
        return deco

    def add_middleware(self, cls, **options):
        self.middleware.append((cls, options))

    def add_exception_handler(self, exc, handler):
        self.exception_handlers[exc] = handler

    def table(self) -> list[tuple[str, str, str | None]]:
        """(method, path, slowapi limit) of every route, in order."""
        return [(m, p, getattr(fn, "limit", None)) for m, p, fn in self.routes]

    def route(self, method: str, path: str):
        return next(fn for m, p, fn in self.routes
                    if (m, p) == (method, path))


class RateLimitExceeded(Exception):
    pass


def _rate_limit_exceeded_handler(request, exc):
    return None


def get_remote_address(request):
    return "127.0.0.1"


class Limiter:
    def __init__(self, key_func):
        self.key_func = key_func

    def limit(self, spec: str):
        def deco(fn):
            fn.limit = spec
            return fn
        return deco


def modules() -> dict[str, types.ModuleType]:
    """The doubles as modules, by the names ``api/server.py`` imports."""
    def module(name, **attrs):
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        return mod

    return {
        "fastapi": module("fastapi", FastAPI=FastAPI, Form=Form,
                          HTTPException=HTTPException, Request=Request,
                          Response=Response, UploadFile=UploadFile),
        "fastapi.middleware": module("fastapi.middleware"),
        "fastapi.middleware.cors": module("fastapi.middleware.cors",
                                          CORSMiddleware=CORSMiddleware),
        "slowapi": module("slowapi", Limiter=Limiter,
                          _rate_limit_exceeded_handler=(
                              _rate_limit_exceeded_handler)),
        "slowapi.errors": module("slowapi.errors",
                                 RateLimitExceeded=RateLimitExceeded),
        "slowapi.util": module("slowapi.util",
                               get_remote_address=get_remote_address),
    }
