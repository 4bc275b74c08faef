"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's wind-tunnel path (``airfoil_tpu_torch``) on the card and
fails (non-zero exit, no result line) if any phase fails:

1. device  — a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build   — builds both CUDA kernels from ``airfoil_tpu_torch/csrc``
   afresh, in parallel, and logs ptxas's registers and spills and the
   tiled kernel's shared memory per block;
3. kernel  — ``lbm_steps`` (one step per launch) against the plain torch
   step on the card, NACA 2412 at alpha=6 on 128x32, 384x192, 640x384 and
   2048x1024 after 1, 8 and 64 steps: rtol 1e-5, atol 1e-6;
4. tiled   — ``lbm_steps_tiled`` (K steps per launch) against the plain
   step (rtol 1e-5, atol 1e-6) and against ``lbm_steps`` (max abs 0: the
   two share their per-cell arithmetic) on 24x12 (a window larger than
   the grid), 128x32, 384x192, 1000x600 (ragged tiles), 2048x1024 and
   4096x2048, after 1, 3, K, 2K+1 and 64 steps, on the NACA mask and on
   one with solid cells on the grid's edges;
5. physics — a CUDA ``WindTunnel`` at 384x192 for 1500 steps at alpha 0
   and 10: finite, CD > 0, CL grows with alpha;
6. large   — a CUDA ``WindTunnel`` at 2048x1024 resolves to the tiled
   kernel and runs 1500 steps at alpha 0 and 10 through it alone (same
   checks); at alpha 10 the one-step kernel gives the same CL and CD;
7. server  — the port's HTTP server on the card: /health, /lbm/start,
   20 /lbm/frame posts (one changes alpha), /lbm/stop; checks every
   decoded field and that the frames went through the one-step kernel;
8. speed   — MLUPS at 640x384, 384x192, 2048x1024 and 4096x2048, the
   4-step call (CUDA events) and the frame latency at 384x192 and
   2048x1024, for the kernels and the plain torch step.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-5, 1e-6
GRIDS = [(128, 32), (384, 192), (640, 384), (2048, 1024)]   # (nx, ny)
STEP_COUNTS = (1, 8, 64)
TILED_GRIDS = [(24, 12), (128, 32), (384, 192), (1000, 600), (2048, 1024),
               (4096, 2048)]
LARGE = (2048, 1024)
SPEED_GRIDS = [(640, 384), (384, 192), (2048, 1024), (4096, 2048)]
N_FRAMES = 20
KERNELS = {   # name: (source, the Pallas kernel it replaces)
    "lbm_steps": ("airfoil_tpu_torch/csrc/lbm_steps.cu",
                  "airfoil_tpu/lbm/kernel.py:55"),     # lbm_steps_pallas
    "lbm_steps_tiled": ("airfoil_tpu_torch/csrc/lbm_steps_tiled.cu",
                        "airfoil_tpu/lbm/kernel.py:144"),
}


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


def noisy_state(core, cfg, dev, rng) -> torch.Tensor:
    """Freestream equilibrium with a seeded 1% perturbation."""
    f0 = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
    noise = rng.standard_normal(tuple(f0.shape)).astype(np.float32)
    return (f0 * (1.0 + 0.01 * torch.tensor(noise, device=dev))).contiguous()


def edge_solid(mask: np.ndarray) -> np.ndarray:
    """``mask`` plus solid cells along row 0, row NY-1, column 0 and the
    outlet column, so that edge cells bounce from wrapped neighbours."""
    m = mask.copy()
    m[0, ::3] = 1.0
    m[-1, 1::3] = 1.0
    m[::3, 0] = 1.0
    m[::5, -1] = 1.0
    return m


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
    """Both libraries, one nvcc each, started together."""
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    loaders = {"lbm_steps": kernel.load, "lbm_steps_tiled": kernel.load_tiled}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()
    log(f"[build] {', '.join(loaders)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in loaders:
        path = os.path.join(cuda_build.BUILD_DIR, f"lib{name}.log")
        with open(path) as fh:
            for line in fh:
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"[build] {name} ptxas: {line.strip()}")
    shape = kernel.tiled_shape()
    log(f"[build] lbm_steps_tiled: {shape['tile_x']}x{shape['tile_y']} tiles, "
        f"{shape['steps']} steps per launch, {shape['smem_bytes']} B of "
        f"dynamic shared memory per block")
    return shape["steps"]


def phase_kernel(dev, kernel, core, masks, cfg_cls):
    """Kernel against the plain torch step; returns the largest abs diff."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for nx, ny in GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                             device=dev)
        f0 = noisy_state(core, cfg, dev, rng)
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


def phase_tiled(dev, kernel, core, masks, cfg_cls, k):
    """Tiled kernel against the plain step and the one-step kernel;
    returns the largest abs diff from the plain step."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for nx, ny in TILED_GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        naca = masks.rasterize_airfoil(naca4_coords(), 6.0, cfg)
        f0 = noisy_state(core, cfg, dev, rng)
        for mask_name, mask in (("naca", naca), ("edge-solid", edge_solid(naca))):
            solid = torch.tensor(mask, device=dev)
            for steps in (1, 3, k, 2 * k + 1, 64):
                before = kernel.tiled_launches
                got = kernel.lbm_steps_tiled(f0, solid, cfg.u0, cfg.tau,
                                             steps=steps)
                torch.cuda.synchronize()
                require(kernel.tiled_launches == before + 1,
                        f"tiled launch counter did not advance at {nx}x{ny}")
                one = kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau, steps=steps)
                want = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps=steps)
                diff = (got - want).abs()
                max_abs = float(diff.max())
                max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
                vs_one = float((got - one).abs().max())
                ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
                log(f"[tiled] {nx}x{ny} {mask_name} steps={steps}: vs plain "
                    f"max_abs={max_abs:.3e} max_rel={max_rel:.3e}; vs "
                    f"lbm_steps max_abs={vs_one:.3e} "
                    f"{'ok' if ok and vs_one == 0.0 else 'FAIL'}")
                require(ok, f"tiled != plain at {nx}x{ny}, {steps} steps")
                require(vs_one == 0.0, f"tiled != lbm_steps at {nx}x{ny}, "
                        f"{steps} steps: {vs_one}")
                require(bool(torch.isfinite(got).all()), "non-finite lattice")
                worst = max(worst, max_abs)
    return worst


def _tunnel_run(WindTunnel, dev, alpha, cfg=None, tiled=None):
    kwargs = {} if cfg is None else {"cfg": cfg}
    wt = WindTunnel(naca4_coords(), device=dev, tiled=tiled, **kwargs)
    wt.set_alpha(alpha)
    out = wt.frame(steps=1500)
    fields_ok = all(bool(torch.isfinite(v[wt.state.solid < 0.5]).all())
                    for v in out["fields"].values())
    log(f"[physics] {wt.cfg.nx}x{wt.cfg.ny} alpha={alpha:g} "
        f"{'tiled' if wt.tiled else 'one-step'} kernel, after {out['step']} "
        f"steps: CL={out['cl']!r} CD={out['cd']!r} "
        f"sep={out['separation']:.4f}")
    require(bool(torch.isfinite(wt.state.f).all()) and fields_ok,
            f"non-finite state at alpha={alpha}")
    require(np.isfinite(out["cl"]) and out["cd"] > 0.0,
            f"CD must be positive at alpha={alpha}")
    return wt, out


def phase_physics(dev, WindTunnel):
    cls = [_tunnel_run(WindTunnel, dev, alpha)[1]["cl"]
           for alpha in (0.0, 10.0)]
    require(cls[1] > cls[0], f"CL must grow with alpha: {cls}")


def phase_large(dev, kernel, WindTunnel, cfg_cls):
    """The large-grid tunnel through the library entry point; returns the
    tiled kernel's launches in that run."""
    cfg = cfg_cls(nx=LARGE[0], ny=LARGE[1])
    kernel.launches = 0
    kernel.tiled_launches = 0
    outs = []
    for alpha in (0.0, 10.0):
        wt, out = _tunnel_run(WindTunnel, dev, alpha, cfg)
        require(wt.tiled is True, f"{LARGE} must resolve to the tiled kernel")
        outs.append(out)
    launches, tiled = kernel.launches, kernel.tiled_launches
    log(f"[large] {LARGE[0]}x{LARGE[1]}: {tiled} tiled kernel calls, "
        f"{launches} one-step kernel calls")
    require(tiled == 2 and launches == 0,
            f"large tunnel: {tiled} tiled and {launches} one-step calls")
    require(outs[1]["cl"] > outs[0]["cl"],
            f"CL must grow with alpha: {[o['cl'] for o in outs]}")
    wt, one = _tunnel_run(WindTunnel, dev, 10.0, cfg, tiled=False)
    require(not wt.tiled and one["cl"] == outs[1]["cl"]
            and one["cd"] == outs[1]["cd"],
            f"one-step kernel CL/CD {one['cl']}/{one['cd']} != tiled "
            f"{outs[1]['cl']}/{outs[1]['cd']}")
    return tiled


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
        kernel.tiled_launches = 0
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
        launches, tiled = kernel.launches, kernel.tiled_launches
        status, _ = _post(url + "/lbm/stop", {"session": meta["session"]})
        require(status == 200, "/lbm/stop failed")
        status, _ = _post(url + "/lbm/frame", {"session": meta["session"]})
        require(status == 404, f"frame after stop -> {status}, want 404")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    require(launches == N_FRAMES and tiled == 0,
            f"{launches} one-step and {tiled} tiled kernel calls for "
            f"{N_FRAMES} frames")
    med = statistics.median(lat)
    log(f"[server] {N_FRAMES} frames at {nx}x{ny} (alpha 6 -> 10), "
        f"{launches} kernel launches, CL={fr['cl']} CD={fr['cd']}, "
        f"median frame latency {med:.3f} ms (HTTP round trip)")
    return launches, med


def phase_speed(dev, card, kernel, core, diagnostics, masks, cfg_cls,
                bench_mlups):
    """MLUPS, the 4-step call and the frame latency for the kernels and the
    plain step, in the order plain, kernels, kernels, plain; returns
    {kernel name: (ms, plain ms)} of the 4-step call, the one-step kernel's
    at 384x192 and the tiled kernel's at 2048x1024."""
    for nx, ny in SPEED_GRIDS:
        big = nx * ny >= LARGE[0] * LARGE[1]
        # The plain step at the large grids takes fewer calls.
        plain = dict(steps_per_call=16, n_calls=2) if big else {}
        runs = [("plain", dict(kernel=False, **plain)),
                ("tiled", dict(kernel=True, tiled=True)),
                ("lbm_steps", dict(kernel=True, tiled=False))]
        runs = runs + runs[::-1]
        rates = {}
        for name, kw in runs:
            r = bench_mlups(nx=nx, ny=ny, device=dev, **kw)
            require(r["finite"] and r["platform"] == "gpu", str(r))
            ms_step = r["seconds"] * 1e3 / r["steps"]
            rates.setdefault(name, []).append(
                f"{r['mlups']:.1f} ({ms_step:.4f} ms/step over "
                f"{r['steps']} steps)")
        log(f"[speed] {nx}x{ny} MLUPS: " + "; ".join(
            f"{name} {', '.join(v)}" for name, v in rates.items())
            + f" ({card})")

    steppers = {"plain": core.lbm_step, "lbm_steps": kernel.lbm_steps,
                "tiled": kernel.lbm_steps_tiled}
    call_ms = {}
    for nx, ny in ((384, 192), LARGE):
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0,
                                                     cfg), device=dev)
        f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
        spf = cfg.steps_per_frame
        for name, step in steppers.items():
            n = 50 if name == "plain" else 200
            ms = cuda_ms(lambda: step(f, solid, cfg.u0, cfg.tau, steps=spf), n)
            call_ms[(nx, ny, name)] = ms
            log(f"[speed] {nx}x{ny}, one {spf}-step call on the device, "
                f"{name}: {ms:.4f} ms ({card})")

        def frame(step):
            def run():
                g = step(f, solid, cfg.u0, cfg.tau, steps=spf)
                cl, cd, sep = diagnostics.forces_and_separation(
                    g, solid, cfg.u0, cfg.chord_cells)
                torch.stack([cl, cd, sep]).tolist()
                diagnostics.render_fields(g, solid, cfg.u0)[0].cpu()
            return run

        order = ["plain", "tiled", "lbm_steps"]
        for name in order + order[::-1]:
            run = frame(steppers[name])
            run()
            t = []
            for _ in range(30):
                t0 = time.perf_counter()
                run()
                t.append((time.perf_counter() - t0) * 1e3)
            log(f"[speed] {nx}x{ny} frame (step + forces + one field to "
                f"host), {name}: median {statistics.median(t):.3f} ms "
                f"({card})")
    return {"lbm_steps": (call_ms[(384, 192, "lbm_steps")],
                          call_ms[(384, 192, "plain")]),
            "lbm_steps_tiled": (call_ms[LARGE + ("tiled",)],
                                call_ms[LARGE + ("plain",)])}


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

    k = phase_build(cuda_build, kernel)
    max_abs = {"lbm_steps": phase_kernel(dev, kernel, core, masks, LBMConfig),
               "lbm_steps_tiled": phase_tiled(dev, kernel, core, masks,
                                              LBMConfig, k)}
    phase_physics(dev, WindTunnel)
    launches = {"lbm_steps_tiled": phase_large(dev, kernel, WindTunnel,
                                               LBMConfig)}
    launches["lbm_steps"], _ = phase_server(
        kernel, make_server, parse_upload, masks.build_mask,
        LBMConfig().steps_per_frame)
    times = phase_speed(dev, card, kernel, core, diagnostics, masks,
                        LBMConfig, bench_mlups)

    jax_loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    require(not jax_loaded, f"jax was imported: {jax_loaded[:5]}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_abs[name],
        "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
