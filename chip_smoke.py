"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's wind-tunnel path (``airfoil_tpu_torch``) on the card and
fails (non-zero exit, no result line) if any phase fails:

1. device  — a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build   — builds the CUDA kernel from ``airfoil_tpu_torch/csrc`` afresh;
3. kernel  — ``lbm_steps`` (CUDA kernel) against the plain torch step on
   the card, NACA 2412 at alpha=6 on 128x32, 384x192, 640x384 and
   2048x1024 after 1, 8 and 64 steps: rtol 1e-5, atol 1e-6;
4. physics — a CUDA ``WindTunnel`` at 384x192 for 1500 steps at alpha 0
   and 10: finite, CD > 0, CL grows with alpha;
5. server  — the port's HTTP server on the card: /health, /lbm/start,
   20 /lbm/frame posts (one changes alpha), /lbm/stop; checks every
   decoded field and that the frames went through the kernel;
6. speed   — MLUPS at 640x384 and 384x192, and the frame latency at
   384x192, for the kernel and for the plain torch step.

The line before last is the card as nvidia-smi names it, the line before
that the kernel table (JSON), and the last line the result (JSON). JAX is
never imported.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-5, 1e-6
GRIDS = [(128, 32), (384, 192), (640, 384), (2048, 1024)]   # (nx, ny)
STEP_COUNTS = (1, 8, 64)
N_FRAMES = 20
KERNEL_SOURCE = "airfoil_tpu_torch/csrc/lbm_steps.cu"
REPLACES = "airfoil_tpu/lbm/kernel.py:55"   # lbm_steps_pallas


def log(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def naca4_coords(m=2, p=4, t=12, n=60) -> np.ndarray:
    """NACA 4-digit loop (open trailing edge, cosine spacing, Selig order
    TE -> upper -> LE -> lower -> TE)."""
    m, p, t = m / 100.0, p / 10.0, t / 100.0
    x = 0.5 * (1.0 - np.cos(np.pi * np.arange(n + 1) / n))
    yt = 5.0 * t * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
                    + 0.2843 * x ** 3 - 0.1015 * x ** 4)
    front = x < p
    yc = np.where(front, m / p ** 2 * (2 * p * x - x ** 2),
                  m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * x - x ** 2))
    theta = np.arctan(np.where(front, 2 * m / p ** 2 * (p - x),
                               2 * m / (1 - p) ** 2 * (p - x)))
    upper = np.stack([x - yt * np.sin(theta), yc + yt * np.cos(theta)], 1)
    lower = np.stack([x + yt * np.sin(theta), yc - yt * np.cos(theta)], 1)
    return np.concatenate([upper[::-1], lower[1:]])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ── phases ──────────────────────────────────────────────────────────────────
def phase_build(cuda_build, kernel):
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    kernel.load()
    log(f"[build] lbm_steps.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    with open(os.path.join(cuda_build.BUILD_DIR, "liblbm_steps.log")) as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")


def phase_kernel(dev, kernel, core, masks, cfg_cls):
    """Kernel against the plain torch step; returns the largest abs diff."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for nx, ny in GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                             device=dev)
        f0 = core.equilibrium_init(ny, nx, cfg.u0, dev)
        noise = rng.standard_normal(tuple(f0.shape)).astype(np.float32)
        f0 = (f0 * (1.0 + 0.01 * torch.tensor(noise, device=dev))).contiguous()
        for steps in STEP_COUNTS:
            before = kernel.launches
            got = kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau, steps=steps)
            want = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps=steps)
            torch.cuda.synchronize()
            require(kernel.launches == before + 1,
                    f"launch counter did not advance at {nx}x{ny}")
            diff = (got - want).abs()
            max_abs = float(diff.max())
            max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            log(f"[kernel] {nx}x{ny} steps={steps}: max_abs={max_abs:.3e} "
                f"max_rel={max_rel:.3e} {'ok' if ok else 'FAIL'}")
            require(ok, f"kernel != plain at {nx}x{ny}, {steps} steps")
            require(bool(torch.isfinite(got).all()), "non-finite lattice")
            worst = max(worst, max_abs)
    return worst


def phase_physics(dev, WindTunnel):
    cls = []
    for alpha in (0.0, 10.0):
        wt = WindTunnel(naca4_coords(), device=dev)
        wt.set_alpha(alpha)
        out = wt.frame(steps=1500)
        fields_ok = all(bool(torch.isfinite(v[wt.state.solid < 0.5]).all())
                        for v in out["fields"].values())
        log(f"[physics] 384x192 alpha={alpha:g} after {out['step']} steps: "
            f"CL={out['cl']:.4f} CD={out['cd']:.4f} "
            f"sep={out['separation']:.4f}")
        require(bool(torch.isfinite(wt.state.f).all()) and fields_ok,
                f"non-finite state at alpha={alpha}")
        require(np.isfinite(out["cl"]) and out["cd"] > 0.0,
                f"CD must be positive at alpha={alpha}")
        cls.append(out["cl"])
    require(cls[1] > cls[0], f"CL must grow with alpha: {cls}")


def _post(url: str, fields: dict, files: dict | None = None):
    """multipart/form-data POST; returns (status, json)."""
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    for k, (fname, data) in (files or {}).items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\n'
                     f'Content-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(kernel, make_server, parse_upload, build_mask, spf):
    """Drives the served /lbm/* path; returns (launches, median frame ms)."""
    dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                    for x, y in naca4_coords())
    dat = dat.encode()
    coords, _ = parse_upload("naca2412.dat", dat)
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        log(f"[server] /health: {health}")
        require(health["backend"] == "cuda" and health["accelerator"],
                "/health must report the CUDA device")

        kernel.launches = 0
        status, meta = _post(url + "/lbm/start", {"alpha": 6.0},
                             {"file": ("naca2412.dat", dat)})
        require(status == 200, f"/lbm/start -> {status} {meta}")
        ny, nx = meta["grid"]
        lat = []
        alpha = 6.0
        for i in range(N_FRAMES):
            form = {"session": meta["session"],
                    "fields": "speed,cp,vorticity"}
            if i == N_FRAMES // 2:
                alpha = 10.0
                form["alpha"] = alpha
            t0 = time.perf_counter()
            status, fr = _post(url + "/lbm/frame", form)
            lat.append((time.perf_counter() - t0) * 1e3)
            require(status == 200, f"/lbm/frame -> {status} {fr}")
            require(fr["alpha"] == alpha, "alpha not applied")
            require(fr["step"] == (i + 1) * spf, f"step {fr['step']}")
            solid = build_mask(coords, alpha)[0].reshape(-1) > 0.5
            require(set(fr["fields"]) == {"speed", "cp", "vorticity"},
                    f"fields {set(fr['fields'])}")
            for name, field in fr["fields"].items():
                a = np.frombuffer(base64.b64decode(field["data"]), np.float32)
                require(a.size == ny * nx, f"{name} size {a.size}")
                require(bool(np.isnan(a[solid]).all()),
                        f"{name}: solid cells must be NaN")
                require(bool(np.isfinite(a[~solid]).all()),
                        f"{name}: fluid cells must be finite")
        launches = kernel.launches
        status, _ = _post(url + "/lbm/stop", {"session": meta["session"]})
        require(status == 200, "/lbm/stop failed")
        status, _ = _post(url + "/lbm/frame", {"session": meta["session"]})
        require(status == 404, f"frame after stop -> {status}, want 404")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    require(launches == N_FRAMES,
            f"{launches} kernel launches for {N_FRAMES} frames")
    med = statistics.median(lat)
    log(f"[server] {N_FRAMES} frames at {nx}x{ny} (alpha 6 -> 10), "
        f"{launches} kernel launches, CL={fr['cl']} CD={fr['cd']}, "
        f"median frame latency {med:.3f} ms (HTTP round trip)")
    return launches, med


def phase_speed(dev, card, kernel, core, diagnostics, masks, cfg_cls,
                bench_mlups):
    """MLUPS and frame latency, kernel and plain, in the order plain,
    kernel, kernel, plain; returns (kernel ms, plain ms) per 4-step call
    at 384x192."""
    for nx, ny in ((640, 384), (384, 192)):
        runs = [bench_mlups(nx=nx, ny=ny, device=dev, kernel=k)
                for k in (False, True, True, False)]
        for r in runs:
            require(r["finite"] and r["platform"] == "gpu", str(r))
        kern = [r["mlups"] for r in runs if r["kernel"]]
        plain = [r["mlups"] for r in runs if not r["kernel"]]
        log(f"[speed] {nx}x{ny}, 128 steps x 8 calls: kernel MLUPS "
            f"{kern[0]:.1f} {kern[1]:.1f}, plain MLUPS {plain[0]:.1f} "
            f"{plain[1]:.1f} ({card})")

    cfg = cfg_cls()
    solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                         device=dev)
    f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
    spf = cfg.steps_per_frame
    kernel_ms = cuda_ms(lambda: kernel.lbm_steps(f, solid, cfg.u0, cfg.tau,
                                                 steps=spf), 200)
    plain_ms = cuda_ms(lambda: core.lbm_step(f, solid, cfg.u0, cfg.tau,
                                             steps=spf), 50)
    log(f"[speed] 384x192, one {spf}-step frame on the device: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")

    def frame(step):
        def run():
            g = step(f, solid, cfg.u0, cfg.tau, steps=spf)
            cl, cd, sep = diagnostics.forces_and_separation(
                g, solid, cfg.u0, cfg.chord_cells)
            torch.stack([cl, cd, sep]).tolist()
            diagnostics.render_fields(g, solid, cfg.u0)[0].cpu()
        return run

    for name, step in (("plain", core.lbm_step), ("kernel", kernel.lbm_steps),
                       ("kernel", kernel.lbm_steps), ("plain", core.lbm_step)):
        run = frame(step)
        run()
        t = []
        for _ in range(30):
            t0 = time.perf_counter()
            run()
            t.append((time.perf_counter() - t0) * 1e3)
        log(f"[speed] 384x192 frame (step + forces + one field to host), "
            f"{name}: median {statistics.median(t):.3f} ms ({card})")
    return kernel_ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import airfoil_tpu_torch
    pkg = os.path.dirname(os.path.abspath(airfoil_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"chip_smoke: airfoil_tpu_torch found at {pkg}, not in this "
              f"checkout ({ROOT})", file=sys.stderr)
        return 1
    from airfoil_tpu.config import LBMConfig
    from airfoil_tpu_torch import cuda_build
    from airfoil_tpu_torch.api.handlers import parse_upload
    from airfoil_tpu_torch.api.minihttp import make_server
    from airfoil_tpu_torch.device import resolve_device
    from airfoil_tpu_torch.lbm import core, diagnostics, kernel, masks
    from airfoil_tpu_torch.lbm.bench import bench_mlups
    from airfoil_tpu_torch.lbm.runner import WindTunnel

    dev = resolve_device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    phase_build(cuda_build, kernel)
    max_abs = phase_kernel(dev, kernel, core, masks, LBMConfig)
    phase_physics(dev, WindTunnel)
    launches, _ = phase_server(kernel, make_server, parse_upload,
                               masks.build_mask, LBMConfig().steps_per_frame)
    kernel_ms, plain_ms = phase_speed(dev, card, kernel, core, diagnostics,
                                      masks, LBMConfig, bench_mlups)

    jax_loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    require(not jax_loaded, f"jax was imported: {jax_loaded[:5]}")
    print(json.dumps({"kernels": [{
        "name": "lbm_steps", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
