"""FastAPI transport for the port's API (optional dependency), and the
service's entry point.

Port of ``airfoil_tpu/api/server.py``: the same routes, the same slowapi
budget when slowapi is installed (root 10/min, health 20/min, solves
5/min, ``/lbm/start`` 10/min), CORS from ``config.ALLOWED_ORIGINS``, at
most ``config.MAX_CONCURRENT_SOLVES`` solves at a time, and each solve on
a worker thread (``anyio.to_thread``). All logic lives in ``handlers``;
``/lbm/frame`` answers ``handlers.encode_reply``'s bytes, as minihttp does,
and ``/lbm/start`` takes its optional ``nx`` as text for
``handlers.lbm_config`` to check (a 400 with a ``detail``).
The device is resolved once, in ``create_app`` (``device.resolve_device``:
``cuda`` unless the caller or ``AIRFOIL_TPU_TORCH_DEVICE`` names another;
``cuda`` without a card raises), and every handler solves on it.

Run: ``python -m airfoil_tpu_torch.api.server`` (port from ``$PORT``).
With FastAPI and uvicorn installed it serves this app through uvicorn;
otherwise the dependency-free ``minihttp.serve``, with the same routes,
as the reference's entry point does. Either way it serves on the
resolved device.
"""

from __future__ import annotations

import asyncio
import logging

from airfoil_tpu_torch import config
from airfoil_tpu_torch.api import handlers
from airfoil_tpu_torch.api.handlers import ApiError, LBMSessions
from airfoil_tpu_torch.device import resolve_device

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
)
logger = logging.getLogger(__name__)

__all__ = ["HAVE_FASTAPI", "app", "create_app", "main"]

try:  # pragma: no cover - optional dependency probe
    from fastapi import (FastAPI, Form, HTTPException, Request, Response,
                         UploadFile)

    HAVE_FASTAPI = True
except ImportError:  # pragma: no cover
    HAVE_FASTAPI = False

if HAVE_FASTAPI:
    from fastapi.middleware.cors import CORSMiddleware

    try:  # pragma: no cover
        from slowapi import Limiter, _rate_limit_exceeded_handler
        from slowapi.errors import RateLimitExceeded
        from slowapi.util import get_remote_address

        _limiter = Limiter(key_func=get_remote_address)

        def _limit(spec):
            return _limiter.limit(spec)

        _HAVE_SLOWAPI = True
    except Exception:  # pragma: no cover
        _limiter = None
        _HAVE_SLOWAPI = False

        def _limit(_spec):
            def deco(fn):
                return fn
            return deco

    def create_app(device=None) -> "FastAPI":
        """The FastAPI app, serving every route on ``device`` (see
        ``resolve_device``)."""
        device = resolve_device(device)
        app = FastAPI(title="Airfoil TPU CFD API")

        @app.on_event("startup")
        async def _warm():
            handlers.start_warmup(device)
        if _HAVE_SLOWAPI:
            app.state.limiter = _limiter
            app.add_exception_handler(RateLimitExceeded,
                                      _rate_limit_exceeded_handler)
        app.add_middleware(
            CORSMiddleware,
            allow_origins=config.ALLOWED_ORIGINS,
            allow_credentials=True,
            allow_methods=["GET", "POST", "HEAD"],
            allow_headers=["*"],
        )
        semaphore = asyncio.Semaphore(config.MAX_CONCURRENT_SOLVES)
        sessions = LBMSessions(device=device)

        def _unwrap(fn, *args, **kwargs):
            try:
                status, payload = fn(*args, **kwargs)
            except ApiError as e:
                raise HTTPException(status_code=e.status_code,
                                    detail=e.detail)
            if status != 200:
                raise HTTPException(status_code=status,
                                    detail=payload.get("detail", ""))
            return payload

        @app.get("/")
        @_limit("10/minute")
        async def root(request: Request):
            return _unwrap(handlers.handle_root)

        @app.head("/health")
        @app.get("/health")
        @_limit("20/minute")
        async def health(request: Request):
            return _unwrap(handlers.handle_health, device)

        @app.get("/stats")
        async def stats(request: Request):
            return _unwrap(handlers.handle_stats)

        @app.post("/upload_airfoil/")
        @_limit("5/minute")
        async def upload_airfoil(request: Request, file: UploadFile,
                                 reynolds: float = Form(...),
                                 alpha: float = Form(...)):
            from anyio import to_thread

            content = await file.read()
            async with semaphore:
                return await to_thread.run_sync(
                    lambda: _unwrap(handlers.handle_upload, file.filename,
                                    content, reynolds, alpha, device=device))

        @app.post("/polar/")
        @_limit("5/minute")
        async def polar(request: Request, file: UploadFile,
                        reynolds: float = Form(...),
                        alpha_start: float = Form(...),
                        alpha_end: float = Form(...),
                        alpha_step: float = Form(1.0)):
            from anyio import to_thread

            content = await file.read()
            async with semaphore:
                return await to_thread.run_sync(
                    lambda: _unwrap(handlers.handle_polar, file.filename,
                                    content, reynolds, alpha_start,
                                    alpha_end, alpha_step, device=device))

        @app.post("/batch/")
        @_limit("5/minute")
        async def batch(request: Request, files: list[UploadFile],
                        reynolds: float = Form(...),
                        alpha: float = Form(...)):
            from anyio import to_thread

            pairs = [(f.filename, await f.read()) for f in files]
            async with semaphore:
                return await to_thread.run_sync(
                    lambda: _unwrap(handlers.handle_batch, pairs,
                                    reynolds, alpha, device=device))

        @app.post("/lbm/start")
        @_limit("10/minute")
        async def lbm_start(request: Request, file: UploadFile,
                            alpha: float = Form(6.0),
                            nx: str | None = Form(None)):
            from anyio import to_thread

            content = await file.read()
            async with semaphore:
                return await to_thread.run_sync(
                    lambda: _unwrap(sessions.start, file.filename, content,
                                    alpha, nx))

        @app.post("/lbm/frame")
        async def lbm_frame(request: Request, session: str = Form(...),
                            alpha: float | None = Form(None),
                            u0: float | None = Form(None),
                            fields: str = Form("speed")):
            from anyio import to_thread

            return await to_thread.run_sync(lambda: Response(
                handlers.encode_reply(_unwrap(sessions.frame, session,
                                              alpha, u0, fields)),
                media_type="application/json"))

        @app.post("/lbm/stop")
        async def lbm_stop(request: Request, session: str = Form(...)):
            return _unwrap(sessions.stop, session)

        return app

    app = create_app()
else:  # pragma: no cover
    def create_app(device=None):
        raise ImportError(
            "FastAPI is not installed. Use the dependency-free server: "
            "python -m airfoil_tpu_torch.api.minihttp")

    app = None


def main() -> None:
    """Serve on ``$PORT``: this app through uvicorn where FastAPI and
    uvicorn are installed, else ``minihttp.serve``. Both serve on the
    resolved device."""
    if HAVE_FASTAPI:
        try:
            import uvicorn
        except ImportError:
            uvicorn = None
        if uvicorn is not None:
            logger.info("transport: FastAPI through uvicorn on port %d "
                        "(device %s)", config.PORT, resolve_device())
            uvicorn.run(app, host="0.0.0.0", port=config.PORT)
            return
    from airfoil_tpu_torch.api.minihttp import serve

    logger.info("transport: minihttp (%s not installed)",
                "uvicorn" if HAVE_FASTAPI else "FastAPI")
    serve()


if __name__ == "__main__":
    main()
