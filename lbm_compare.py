"""The LBM kernels of this checkout against an older source of them, on one
GPU: ``python3 lbm_compare.py OLD_CSRC``.

``OLD_CSRC`` is a directory holding an older ``lbm_steps.cu``,
``lbm_steps_tiled.cu`` and ``lbm_cell.cuh`` with the C interface of the
one-step-per-launch kernels (``lbm_steps_launch(f, out, scratch, solid,
bits, ...)``, the bounce bits built in every call), for example those of
the commit before the resident redesign::

    mkdir -p scratch/old && git archive HEAD~1 airfoil_tpu_torch/csrc \\
        | tar -x -C scratch/old --strip-components=2
    python3 lbm_compare.py scratch/old

1. build — the old sources and, with the wrapper's flags, the checkout's
   tiled kernel in the variants named by ``VARIANTS`` (tile, steps per
   launch, threads), one nvcc each, in parallel; ptxas's registers, stack
   frames and spills of each kernel; the checkout's own libraries through
   the wrapper;
2. bits  — every input of ``chip_smoke.py``'s kernel and tiled phases
   through the old one-step kernel, the old tiled kernel, the new tiled
   kernel and, where it holds the grid, the new resident kernel: all equal
   bit for bit (NaNs included); every tiled variant equal to them at
   2048x1024 after 9 steps;
3. speed — the builds in turns (old, new, new, old): the 4-step call at
   384x192 (old ``lbm_steps`` against the resident kernel) and at
   2048x1024 (old and new ``lbm_steps_tiled``), by CUDA events over
   back-to-back calls and by the profiler's device time of all the call's
   kernels; MLUPS (128 steps a call, 8 calls, host clock between two
   synchronisations, as ``lbm/bench.py``) at 640x384, 384x192, 2048x1024
   and 4096x2048, and at 1024x512 (the band that moved from the old
   one-step kernel to the new tiled one), each build by its own selection
   rule (old: the one-step kernel while two lattices fit in L2; new:
   ``prefers_tiled``); and the library frame at 384x192 (the 4-step call,
   forces and separation to the host, one field to the host: the served
   frame's work short of encoding), median of 30. Then each tiled
   variant's 4-step call at 2048x1024
   and MLUPS at 4096x2048, in turns with the checkout's default;
4. resident against tiled — the checkout's two kernels where both run
   (384x192, 640x384), in turns (resident, tiled, tiled, resident): calls
   of 4 and 128 steps by CUDA events and by device time, and for the
   4-step call the host's issue time per call, through the wrapper and as
   a bare ctypes launch with every argument made beforehand.

Prints the card's name and power limit first; exits non-zero if a build
fails or two kernels differ.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from airfoil_tpu_torch import cuda_build
from airfoil_tpu_torch.lbm.core import edge_equilibrium, inverse_tau

OUT = os.path.join(cs.ROOT, "airfoil_tpu_torch", "_build", "lbm_compare")
SPEED_STEPS, SPEED_CALLS = 128, 8
# name: nvcc -D flags of the checkout's tiled kernel (its default first).
VARIANTS = {
    "32x16 K4 512t": [],
    "32x16 K4 256t": ["-DLBM_TILED_THREADS=256"],
    "64x16 K4 512t": ["-DLBM_TILE_X=64"],
    "64x16 K4 256t": ["-DLBM_TILE_X=64", "-DLBM_TILED_THREADS=256"],
    "32x16 K8 512t": ["-DLBM_STEPS=8"],
    "32x16 K8 256t": ["-DLBM_STEPS=8", "-DLBM_TILED_THREADS=256"],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(name: str, csrc: str, source: str, flags) -> tuple:
    """Builds ``csrc/source`` as library ``name``; (library, ptxas usage)."""
    d = os.path.join(OUT, name.replace(" ", "_"))
    shutil.copytree(csrc, d, ignore=shutil.ignore_patterns("*.so", "*.o"))
    so = os.path.join(d, "lib.so")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           *flags, "-o", so, os.path.join(d, source)],
                          capture_output=True, text=True)
    cs.require(proc.returncode == 0, f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.lbm_error_string.argtypes = [_I]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib, cs.ptxas_usage(proc.stderr)


def old_call(lib, launch: str):
    """The old wrapper around ``lib.launch``: one call of `steps` steps."""
    fn = getattr(lib, launch)
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _F, _I, _P]
    fn.restype = _I

    def call(f, solid, u0, tau, steps=4, word=None):
        ny, nx = f.shape[1], f.shape[2]
        out = torch.empty_like(f)
        scratch = torch.empty_like(f) if steps > 1 else None
        bits = torch.empty((ny, nx), dtype=torch.int16, device=f.device)
        feq = (ctypes.c_float * 9)(*edge_equilibrium(u0))
        err = fn(f.data_ptr(), out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 solid.data_ptr(), bits.data_ptr(), ny, nx, int(steps), feq,
                 inverse_tau(tau), f.device.index or 0,
                 torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, f"old {launch}: {lib.lbm_error_string(err)}")
        return out
    return call


def call_device_ms(fn, n: int, kernels: dict) -> float:
    """Device milliseconds of one call of ``fn``, which launches
    ``kernels[name]`` kernels whose names hold ``name``: per name, the
    profiler's mean over the launches it recorded in ``n`` calls."""
    fn()
    with cs.traced() as prof:
        for _ in range(n):
            fn()
    ev = cs.kernel_events(prof, *kernels)
    total = 0.0
    for name, per_call in kernels.items():
        count, us = ev[name]
        cs.require(count >= n * per_call // 2,
                   f"{count} {name} records of {n} calls")
        total += us / count * per_call
    return total / 1e3


def mlups(step, f, solid, u0, tau) -> float:
    f = step(f, solid, u0, tau, steps=SPEED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SPEED_CALLS):
        f = step(f, solid, u0, tau, steps=SPEED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cs.require(bool(torch.isfinite(f).all()), "non-finite lattice")
    return f.shape[1] * f.shape[2] * SPEED_STEPS * SPEED_CALLS / dt / 1e6


def main(old_dir: str) -> int:
    if not torch.cuda.is_available():
        print("lbm_compare: no CUDA device", file=sys.stderr)
        return 1
    from airfoil_tpu_torch.config import LBMConfig
    from airfoil_tpu_torch.lbm import core, kernel, masks

    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"[device] {card}")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    jobs = {"old lbm_steps": (old_dir, "lbm_steps.cu", []),
            "old lbm_steps_tiled": (old_dir, "lbm_steps_tiled.cu", [])}
    jobs.update({v: (cuda_build.CSRC_DIR, "lbm_steps_tiled.cu", flags)
                 for v, flags in VARIANTS.items()})
    with ThreadPoolExecutor(len(jobs) + 2) as pool:
        futs = {n: pool.submit(build, n, *job) for n, job in jobs.items()}
        new_libs = [pool.submit(kernel.load), pool.submit(kernel.load_tiled)]
        built = {n: f.result() for n, f in futs.items()}
        for f in new_libs:
            f.result()
    for name, (_, use) in built.items():
        cs.log(f"[build] {name}: ptxas {json.dumps(use)}")
    old_one = old_call(built["old lbm_steps"][0], "lbm_steps_launch")
    old_tiled = old_call(built["old lbm_steps_tiled"][0],
                         "lbm_steps_tiled_launch")
    load_tiled = kernel.load_tiled

    @contextlib.contextmanager
    def variant(name):
        lib = built[name][0]
        lib.lbm_steps_tiled_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                               _P, _F, _I, _P]
        lib.lbm_steps_tiled_launch.restype = _I
        lib.lbm_tiled_shape.argtypes = [_I, ctypes.POINTER(_I)]
        lib.lbm_tiled_shape.restype = _I
        kernel.load_tiled = lambda: lib
        kernel._tiled_shape.cache_clear()
        try:
            yield kernel.tiled_shape(dev)
        finally:
            kernel.load_tiled = load_tiled
            kernel._tiled_shape.cache_clear()

    for name in VARIANTS:
        with variant(name) as shape:
            cs.log(f"[build] {name}: {json.dumps(shape)}; window ratio "
                   f"{(shape['tile_x'] + 2 * shape['steps']) * (shape['tile_y'] + 2 * shape['steps']) / (shape['tile_x'] * shape['tile_y']):.4f}")

    # Bits: chip_smoke's kernel and tiled inputs through all the kernels.
    limits = kernel.device_limits(dev)
    rng = np.random.default_rng(0)
    n_runs = 0
    grids = [(g, ("naca",), cs.STEP_COUNTS) for g in cs.GRIDS]
    grids += [(g, ("naca", "edge-solid"), (1, 3, 4, 9, 64))
              for g in cs.TILED_GRIDS]
    for (nx, ny), mask_names, step_counts in grids:
        cfg = LBMConfig(nx=nx, ny=ny)
        naca = masks.rasterize_airfoil(cs.naca4_coords(), 6.0, cfg)
        f0 = cs.noisy_state(core, cfg, dev, rng)
        resident = not kernel.prefers_tiled(ny, nx, *limits)
        for mask_name in mask_names:
            mask = naca if mask_name == "naca" else cs.edge_solid(naca)
            solid = torch.tensor(mask, device=dev)
            word = kernel.cell_word(solid)
            for steps in step_counts:
                ref = old_one(f0, solid, cfg.u0, cfg.tau, steps=steps)
                outs = {"old tiled": old_tiled(f0, solid, cfg.u0, cfg.tau,
                                               steps=steps),
                        "new tiled": kernel.lbm_steps_tiled(
                            f0, solid, cfg.u0, cfg.tau, steps=steps,
                            word=word)}
                if resident:
                    outs["new lbm_steps"] = kernel.lbm_steps(
                        f0, solid, cfg.u0, cfg.tau, steps=steps, word=word)
                torch.cuda.synchronize()
                for name, out in outs.items():
                    cs.require(cs._same_bits([out], [ref]),
                               f"{name} != old lbm_steps at {nx}x{ny} "
                               f"{mask_name}, {steps} steps")
                n_runs += 1
        cs.log(f"[bits] {nx}x{ny}: {', '.join(outs)} = old lbm_steps bit for "
               f"bit ({len(mask_names)} masks x {len(step_counts)} step "
               f"counts)")
    cfg = LBMConfig(nx=2048, ny=1024)
    solid = torch.tensor(masks.rasterize_airfoil(cs.naca4_coords(), 6.0, cfg),
                         device=dev)
    word = kernel.cell_word(solid)
    f0 = cs.noisy_state(core, cfg, dev, rng)
    ref = old_one(f0, solid, cfg.u0, cfg.tau, steps=9)
    for name in VARIANTS:
        with variant(name):
            out = kernel.lbm_steps_tiled(f0, solid, cfg.u0, cfg.tau, steps=9,
                                         word=word)
            torch.cuda.synchronize()
            cs.require(cs._same_bits([out], [ref]), f"variant {name} differs")
    cs.log(f"[bits] {n_runs} inputs of chip_smoke's kernel and tiled phases: "
           f"every kernel equal to the old one-step kernel bit for bit; "
           f"every tiled variant too at 2048x1024, 9 steps")

    # Speed, in turns.
    def setup(nx, ny):
        cfg = LBMConfig(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(cs.naca4_coords(), 6.0,
                                                     cfg), device=dev)
        f = core.equilibrium_init(ny, nx, cfg.u0, dev)
        return cfg, solid, kernel.cell_word(solid), f

    def new_step(nx, ny, word):
        step = (kernel.lbm_steps_tiled if kernel.prefers_tiled(ny, nx, *limits)
                else kernel.lbm_steps)
        return lambda *a, **k: step(*a, word=word, **k)

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    calls = {}
    rates = {}
    frames = {}
    for build_name in ("old", "new", "new", "old"):
        for nx, ny in ((384, 192), cs.LARGE):
            cfg, solid, word, f = setup(nx, ny)
            if build_name == "old":
                tiled = 2 * f.numel() * 4 > l2
                step = old_tiled if tiled else old_one
                kernels = {"bounce_bits_kernel": 1,
                           "lbm_tiled_kernel" if tiled else "lbm_step_kernel":
                           1 if tiled else 4}
            else:
                step = new_step(nx, ny, word)
                kernels = {"lbm_tiled_kernel" if kernel.prefers_tiled(
                    ny, nx, *limits) else "lbm_resident_kernel": 1}
            run = lambda: step(f, solid, cfg.u0, cfg.tau, steps=4)
            calls.setdefault((build_name, nx, ny), []).append(
                (cs.cuda_ms(run, 200), call_device_ms(run, 20, kernels)))
        for nx, ny in cs.SPEED_GRIDS + [(1024, 512)]:
            cfg, solid, word, f = setup(nx, ny)
            if build_name == "old":
                step = old_tiled if 2 * f.numel() * 4 > l2 else old_one
            else:
                step = new_step(nx, ny, word)
            rates.setdefault((build_name, nx, ny), []).append(
                mlups(step, f, solid, cfg.u0, cfg.tau))
        cfg, solid, word, f = setup(384, 192)
        step = old_one if build_name == "old" else new_step(384, 192, word)
        frames.setdefault(build_name, []).append(frame_ms(
            lambda: step(f, solid, cfg.u0, cfg.tau, steps=4), solid, cfg))
    for (build_name, nx, ny), v in calls.items():
        cs.log(f"[speed] {build_name}: {nx}x{ny} 4-step call " + ", ".join(
            f"{ms:.4f} ms (device {dms * 1e3:.2f} us)" for ms, dms in v)
            + f" ({card})")
    for (build_name, nx, ny), v in rates.items():
        cs.log(f"[speed] {build_name}: {nx}x{ny} MLUPS "
               + ", ".join(f"{r:.1f}" for r in v) + f" ({card})")
    for build_name, v in frames.items():
        cs.log(f"[speed] {build_name}: 384x192 frame (4-step call, forces, one "
               f"field to host) median " + ", ".join(f"{ms:.3f}" for ms in v)
               + f" ms ({card})")

    cfg, solid, word, f = setup(*cs.LARGE)
    cfg4, solid4, word4, f4 = setup(4096, 2048)
    names = list(VARIANTS)
    for name in names + names[::-1]:
        with variant(name):
            run = lambda: kernel.lbm_steps_tiled(f, solid, cfg.u0, cfg.tau,
                                                 steps=4, word=word)
            ms = cs.cuda_ms(run, 200)
            dms = cs.device_ms(run, 20, "lbm_tiled_kernel")
            step = lambda *a, **k: kernel.lbm_steps_tiled(*a, word=word4, **k)
            rate = mlups(step, f4, solid4, cfg4.u0, cfg4.tau)
        cs.log(f"[variant] {name}: 2048x1024 4-step call {ms:.4f} ms (device "
               f"{dms * 1e3:.2f} us); 4096x2048 {rate:.1f} MLUPS ({card})")

    # The checkout's resident kernel against its tiled one, in turns.
    index = dev.index or 0
    stream = torch.cuda.current_stream().cuda_stream
    k = kernel.tiled_shape(dev)["steps"]
    for name in ("resident", "tiled", "tiled", "resident"):
        resident = name == "resident"
        kern = "lbm_resident_kernel" if resident else "lbm_tiled_kernel"
        for nx, ny in ((384, 192), (640, 384)):
            cfg, solid, word, f = setup(nx, ny)
            step = kernel.lbm_steps if resident else kernel.lbm_steps_tiled
            for steps in (4, 128):
                run = lambda: step(f, solid, cfg.u0, cfg.tau, steps=steps,
                                   word=word)
                ms = cs.cuda_ms(run, 200 if steps == 4 else 50)
                dms = call_device_ms(
                    run, 20, {kern: 1 if resident else -(-steps // k)})
                line = (f"[head] {name}: {nx}x{ny} {steps}-step call "
                        f"{ms:.4f} ms ({nx * ny * steps / ms / 1e3:.1f} "
                        f"MLUPS), device {dms * 1e3:.2f} us")
                if steps == 4:
                    line += (f"; host issue {issue_us(run, 200):.2f} us a "
                             f"call, bare launch {issue_us(bare_launch(kernel, resident, f, word, cfg, index, stream), 200):.2f} us")
                cs.log(line + f" ({card})")
    return 0


def frame_ms(step, solid, cfg, n: int = 30) -> float:
    """Median host milliseconds of a library frame: ``step()`` then the
    tunnel's forces and separation and one field, read back."""
    from airfoil_tpu_torch.lbm import diagnostics

    def run():
        g = step()
        cl, cd, sep = diagnostics.forces_and_separation(g, solid, cfg.u0,
                                                        cfg.chord_cells)
        torch.stack([cl, cd, sep]).tolist()
        diagnostics.render_fields(g, solid, cfg.u0)[0].cpu()

    run()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def issue_us(fn, n: int) -> float:
    """Host microseconds to issue one call of ``fn``: ``n`` calls from an
    idle card, timed up to the last return (the card keeps up, so the
    queue never blocks)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bare_launch(kernel, resident: bool, f, word, cfg, index: int, stream):
    """One 4-step call's ctypes launch with its arguments and output made
    beforehand: the wrapper's cost without its Python."""
    ny, nx = f.shape[1], f.shape[2]
    feq, inv_tau = kernel._params(float(cfg.u0), float(cfg.tau))
    if resident:
        lib = kernel.load()
        plan = kernel.resident_plan(ny, nx, *kernel.device_limits(f.device))
        buf = torch.empty(f.numel() + plan.exchange_floats, device=f.device)
        args = (f.data_ptr(), buf.data_ptr(), buf[f.numel():].data_ptr(),
                word.data_ptr(), ny, nx, 4, plan.tiles_x, plan.tiles_y,
                plan.tile_w, plan.tile_h, feq, inv_tau, index, stream)
        fn = lib.lbm_steps_launch
    else:
        lib = kernel.load_tiled()
        out = torch.empty_like(f)
        args = (f.data_ptr(), out.data_ptr(), None, word.data_ptr(), ny, nx,
                4, feq, inv_tau, index, stream)
        fn = lib.lbm_steps_tiled_launch

    def run():
        cs.require(fn(*args) == 0, "bare launch failed")
    run.keep = (buf if resident else out)
    return run


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
