"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's wind-tunnel path, its XFOIL-replacement path, its
single-point analysis service and its polar and batch analyses
(``airfoil_tpu_torch``) on the card and
fails (non-zero exit, no result line) if any phase fails:

1. device  — a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build   — builds the three CUDA libraries (``lbm_steps``,
   ``lbm_steps_tiled``, ``bl_march``) from ``airfoil_tpu_torch/csrc``
   afresh, one nvcc each, in parallel, and logs ptxas's registers, stack
   frames and spills, the resident kernel's tiling and shared memory at
   the served grid and the tiled kernel's tile, shared memory and blocks
   per SM; every LBM and march kernel must have a 0-byte stack frame and
   no spills;
3. kernel  — ``cell_word`` (one launch) equal to the plain word on every
   grid and mask below; ``lbm_steps`` (the lattice on chip for a whole
   call, one cooperative launch) against the plain torch step on the card,
   NACA 2412 at alpha=6 on 128x32, 384x192 and 640x384 after 1, 8 and 64
   steps: rtol 1e-5, atol 1e-6; one 64-step call traced by the profiler
   is exactly one kernel; past its capacity (1024x512, and the 2:1 grid
   one step of 8 rows past the largest it holds) it raises ValueError
   without a launch;
4. server  — the port's HTTP server on the card: /health, /lbm/start,
   20 /lbm/frame posts (one changes alpha), /lbm/stop; checks every
   decoded field, that the frames went through ``lbm_steps`` and the
   three masks' words (start, alpha change) through ``cell_word``, and,
   from a ``torch.profiler``
   trace of one frame, that a frame launches exactly one LBM kernel and
   no word kernel;
5. tiled   — ``lbm_steps_tiled`` (K steps per launch, persistent,
   TMA-fed) against the plain step (rtol 1e-5, atol 1e-6) and, wherever
   ``lbm_steps`` holds the grid, against it (max abs 0: the two share
   their per-cell arithmetic) on 24x12 (a window larger than the grid),
   128x32, 384x192, 1000x600 (ragged tiles), 1002x600 (NX % 4 != 0: every
   window by the plain-load path), 2048x1024 and 4096x2048, after 1, 3, K,
   2K+1 and 64 steps, on the NACA mask and on one with solid cells on the
   grid's edges;
6. physics — a CUDA ``WindTunnel`` at 384x192 for 1500 steps at alpha 0
   and 10: finite, CD > 0, CL grows with alpha;
7. large   — a CUDA ``WindTunnel`` at 2048x1024 resolves to the tiled
   kernel and runs 1500 steps at alpha 0 and 10 through it alone (same
   checks); at the largest 2:1 grid ``lbm_steps`` holds, 1500 steps at
   alpha 10 through each kernel give the same CL and CD;
8. speed   — MLUPS at 640x384, 384x192, 2048x1024 and 4096x2048, the
   4-step call (CUDA events, and device time from the profiler) and the
   frame latency at 384x192 and 2048x1024, for the kernels (``lbm_steps``
   where it holds the grid) and the plain torch step.

Then the XFOIL-replacement path (paneling -> panel solver -> coupled
viscous solve), held to the JAX package's outputs in
``tests/golden/torch_viscous.json`` (written by
``tests/make_torch_goldens.py``):

9.  inviscid — ``build_operator`` + ``solve_inviscid`` on the card for
    NACA 0012, 2412 and 4412 at 160 panels, alpha 0 and 5: CL and Cm
    within rtol 1e-4 (atol 1e-5, for the zero-lift cases) of the goldens;
10. march    — the ``bl_march`` kernel against the plain torch march on the
    card: theta, dstar, hk, cf within rtol 1e-4, identical flags and
    x_transition, on every station of five flat-plate lanes (Blasius,
    tripped, free transition at 6e6 and 1e7, none at 2e5), of the NACA
    2412 sides at alpha 0 and 5 tripped at x 0.05 (where the plain
    march's own rounding ensemble must not spread), and of the inputs the
    main path gives the kernel: all 25 side-pair marches of a default
    solve tripped at x 0.05 (the ensemble may spread at the last station
    alone, which is then left out) and all 50 wake marches of that solve
    (whose ensemble must not spread) and of a free one (NACA 2412, alpha
    5), each launched at the shape the solve gives it (2 side lanes, 1
    wake lane) and bit-equal to its lanes of the batch. The free NACA 2412
    sides and the free solve's wakes are held up to the first station
    where the plain march's ensemble spreads, and the sides' x_transition
    must be one of that ensemble's. Then the physics anchors on the
    kernel alone;
11. viscous  — ``solve_viscous`` at its defaults (160 panels, 80 stations,
    24 wake stations, 24 passes) for NACA 2412 at alpha 0 and 5 and NACA
    0012 at 0, +-4 and 16, Re 1e6: CL within 0.025, CD within 5 %, Cm
    within 0.01 and x_transition within 0.05 c of the golden ensemble's
    range, ``converged`` one of its values (alpha 16 must not converge);
    and tripped at x 0.05 (NACA 2412 at alpha 0 and 5, 0012 at 4), where
    the reference is no knife edge, at the same bars around the nominal
    golden run and ``converged`` equal to it; exactly 2 x 25 march
    launches per solve (25 of ``march_side_kernel``, 25 of
    ``march_wake_kernel``); then the slow-tier anchors of
    ``tests/test_viscous.py`` (three more solves: 0012 at Re 5e5 and 5e6,
    and tripped at x 0.1);
12. viscous speed — the default solve's wall time, its split and a
    ``torch.profiler`` trace of it (device time of the march kernels and
    of all operations); one side-pair march at 80 stations with the
    kernel and the plain march (its device operations counted by the
    profiler over its first intervals); the side kernel at 1 lane (each
    side), 2, 62 (a 31-point polar's sides) and 1,914 lanes (the march
    phase's batch), and the wake kernel at 24 stations with its plain
    march.

Then the simultaneous-Newton path (``viscous.newton`` -> ``polar.analyze``
-> ``POST /upload_airfoil/``), held to ``tests/golden/torch_newton.json``
(``tests/make_torch_newton_goldens.py``) at the same bars, around the range
of the reference ensemble's members with the same ``converged``:

13. newton march — every side and wake march of a tripped (x 0.05) and a
    free default Newton solve (NACA 2412, alpha 4: 96 stations a side, 20
    in the wake), as the lanes of one batch with the plain march's
    rounding ensemble, held as in phase 10, and each launched at its own
    shape and bit-equal to its lanes of the batch;
14. newton — the default ``solve_viscous_newton`` at the five golden
    points, ``solve_polar_point`` at NACA 2412 alpha 8 and both
    continuation solves from the reference's donor state to alpha 10;
    exactly 10 side + 1 wake march launches a default solve (3 + 1 a
    continuation); one LM iteration, of one lane and of eight lanes side
    by side, under ``torch.cuda.set_sync_debug_mode("error")``: no host
    synchronisation;
15. analyze — ``analyze_airfoil`` (NACA 2412, 80 points a side) at alpha 4:
    viscous, the coefficients against the golden ensemble, the full
    boundary-layer schema; at alpha 19: inviscid, strategy 3, the warning,
    CD 0, CL and Cm as the reference's; the solver calls beside the
    reference's;
16. upload — ``POST /upload_airfoil/`` on the port's server on the card
    with the golden's file at Re 1e6, alpha 5: the reply's schema and
    coordinates as the reference's, the coefficients within the bars of
    its ensemble, one run log, the analysis counter up by one;
17. polar — ``solve_polar`` (NACA 2412, 80 points a side, alpha -2..6
    step 2, Re 1e6: 5 points in a bucket of 8 lanes), held to
    ``tests/golden/torch_polar.json`` (``tests/make_torch_polar_goldens.py``):
    each point's ``mode`` one of the reference ensemble's, CL, CD, Cm and
    x_transition within the bars of the members with its mode and
    ``converged``; the sweep's march launches and lanes (10 of 16 side
    lanes and 1 of 8 wakes a per-point or rescue pass, 3 of 2 and 1 of 1 a
    walk solve) and the walk's continuation and trip solves counted; the
    per-point pass's marches held to the plain march as in phase 13 (a
    free lane whose ensemble's x_transition takes several values may land
    between them: 160 free lanes meet that knife edge where the Newton
    phases' 40 did not); the
    per-point pass's wall, device time and busy share; one LM iteration
    at 1, 8 and 64 lanes (wall, device time); both march kernels at 64
    and 128 lanes with their bounds;
18. batch — ``solve_batch`` of NACA 2412 (80 a side) and 0012 (70) at
    alpha 2: each lane held to its golden ensemble, 10 + 1 launches;
19. served — ``POST /polar/`` with the same sweep equal to the library's
    polar to the JSON's rounding, ``POST /batch/`` with the two files (N
    parts named ``files``) equal to the library's batch, ``GET /stats``
    up by the three analyses served;
20. newton speed — median wall of 10 default solves, the LM iterations and
    host synchronisations of a solve, its device time and busy share; one
    LM iteration's dispatched operations, device kernels and time, the
    four batched Cholesky solves, ``_reproject_n``; the march kernels at
    96 and 20 stations with their plain times and bounds; the analyze and
    upload wall times.

Each kernel's bound is the larger of the bytes its call must move (inputs
read once, outputs written once) over the card's memory rate and the
operations of its plain version on the same inputs (pointwise torch
operations times elements, counted by a dispatch mode) over the card's
float32 rate. No single PyTorch call computes an LBM step, a cell word or
a march, so ``library_ms`` is null. ``ms`` is the CUDA-event time of a
call among back-to-back calls, ``device_ms`` the profiler's device time
of the call's kernels.

The line before last is the card as nvidia-smi names it, the line before
that the kernel table (JSON; the march entries add ``newton_*`` keys: the
Newton path's launches and the kernels at its shapes, and ``polar_*``
keys: the polar's launches, lanes a launch, and the kernels at 64 and 128
lanes with their bounds), and the last line
the result (JSON). JAX is never imported, nor anything of ``airfoil_tpu``.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-5, 1e-6
GRIDS = [(128, 32), (384, 192), (640, 384)]   # (nx, ny)
PAST_CAPACITY = (1024, 512)
STEP_COUNTS = (1, 8, 64)
TILED_GRIDS = [(24, 12), (128, 32), (384, 192), (1000, 600), (1002, 600),
               (2048, 1024), (4096, 2048)]
LARGE = (2048, 1024)
SPEED_GRIDS = [(640, 384), (384, 192), (2048, 1024), (4096, 2048)]
N_FRAMES = 20
PROFILE_PAD = 0.25   # seconds of idle time around a profiled region
KERNELS = {   # name: (source, the TPU code it replaces)
    "lbm_steps": ("airfoil_tpu_torch/csrc/lbm_steps.cu",
                  "airfoil_tpu/lbm/kernel.py:55"),     # lbm_steps_pallas
    "cell_word": ("airfoil_tpu_torch/csrc/lbm_steps.cu",
                  "airfoil_tpu/lbm/kernel.py:45"),     # its hoisted rolls
    "lbm_steps_tiled": ("airfoil_tpu_torch/csrc/lbm_steps_tiled.cu",
                        "airfoil_tpu/lbm/kernel.py:144"),
    "bl_march": ("airfoil_tpu_torch/csrc/bl_march.cu",
                 "airfoil_tpu/viscous/march.py:157"),  # march_side's scan
    "bl_march_wake": ("airfoil_tpu_torch/csrc/bl_march.cu",
                      "airfoil_tpu/viscous/march.py:352"),  # march_wake's
}
# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes
# per second and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
POLAR_ALPHAS = tuple(float(a) for a in range(-10, 21))   # 31 points
GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_viscous.json")
NEWTON_GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_newton.json")
N_PANELS = 160
MARCH_RTOL = 1e-4
ENSEMBLE_K = np.arange(-16, 17)
PROFILED_INTERVALS = 4
# (absolute, relative) bar of each viscous output around the golden range.
VISCOUS_BARS = {"cl": (0.025, 0.0), "cd": (0.0, 0.05), "cm": (0.01, 0.0),
                "xtr_upper": (0.05, 0.0), "xtr_lower": (0.05, 0.0)}
FLAT_PLATE = [(1e6, 30.0, 1.0), (1e6, 9.0, 0.05), (6e6, 9.0, 1.0),
              (1e7, 9.0, 1.0), (2e5, 9.0, 1.0)]    # (Re, n_crit, x_trip)
FALKNER_SKAN = [(0.0, 2.591), (-0.05, 2.676), (-0.10, 2.801),
                (-0.14, 2.963)]                    # (beta, H)


def log(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def naca4_coords(m=2, p=4, t=12, n=60) -> np.ndarray:
    """NACA 4-digit loop (open trailing edge, cosine spacing, Selig order
    TE -> upper -> LE -> lower -> TE) from the port's ``models.naca4``, the
    formula that made the golden outputs."""
    from airfoil_tpu_torch.models import naca4
    return naca4(m, p, t, n)


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


def count_ops(fn, *args, **kwargs) -> int:
    """Operations of ``fn`` on its inputs: the elements written by every
    pointwise torch operation it runs, one operation each."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                total += sum(o.numel() for o in tree_leaves(out)
                             if torch.is_tensor(o))
            return out

    with Count():
        fn(*args, **kwargs)
    return total


def count_dispatches(fn, *args) -> int:
    """Torch operations that ``fn`` dispatches (views included): what the
    host issues, one by one."""
    from torch.utils._python_dispatch import TorchDispatchMode
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            total += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return total


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``moved_bytes`` and do ``ops`` float32 operations."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_name(mangled: str) -> str:
    """A mangled kernel name shortened to the function's:
    ``march_side_kernel``."""
    m = re.search(r"[A-Za-z_]+_kernel", mangled)
    return m.group(0) if m else mangled


def ptxas_usage(log_text: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output (names as ``kernel_name`` gives them)."""
    usage, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


# ── phases ──────────────────────────────────────────────────────────────────
def phase_build(cuda_build, kernel, march_kernel):
    """The three libraries, one nvcc each, started together."""
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    loaders = {"lbm_steps": kernel.load, "lbm_steps_tiled": kernel.load_tiled,
               "bl_march": march_kernel.load}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()
    log(f"[build] {', '.join(loaders)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in loaders:
        path = os.path.join(cuda_build.BUILD_DIR, f"lib{name}.log")
        with open(path) as fh:
            usage = ptxas_usage(fh.read())
        require(usage, f"{name}: ptxas reported no kernel")
        for fn, use in usage.items():
            log(f"[build] {name} ptxas: {fn}: {json.dumps(use)}")
            require(use.get("stack") == 0 and use.get("spill_stores") == 0
                    and use.get("spill_loads") == 0,
                    f"{fn} uses local memory: {use}")
    dev = torch.device("cuda")
    sm_count, smem = kernel.device_limits(dev)
    plan = kernel.resident_plan(192, 384, sm_count, smem)
    log(f"[build] lbm_steps at 384x192 on {sm_count} SMs ({smem} B of "
        f"shared memory a block): {plan.tiles_x}x{plan.tiles_y} blocks of "
        f"{kernel.RESIDENT_THREADS} threads on {plan.tile_w}x{plan.tile_h} "
        f"tiles, {plan.smem_bytes} B of dynamic shared memory a block, "
        f"{plan.exchange_floats * 4} B of exchange surfaces")
    shape = kernel.tiled_shape(dev)
    log(f"[build] lbm_steps_tiled: {shape['tile_x']}x{shape['tile_y']} tiles, "
        f"{shape['steps']} steps per launch, {shape['threads']} threads and "
        f"{shape['smem_bytes']} B of dynamic shared memory a block, "
        f"{shape['blocks_per_sm']} blocks an SM")
    return shape["steps"]


def largest_resident(kernel, dev) -> tuple[int, int]:
    """The largest 2:1 grid (nx, ny), ny a multiple of 8, that ``lbm_steps``
    holds on this card."""
    limits = kernel.device_limits(dev)
    ny = 8
    while not kernel.prefers_tiled(ny + 8, 2 * (ny + 8), *limits):
        ny += 8
    return 2 * ny, ny


@contextlib.contextmanager
def traced():
    """A ``torch.profiler`` trace of the card whose window is padded with
    PROFILE_PAD seconds of idle time on both sides: the profiler drops
    device records that it places (by its CPU-to-device clock alignment,
    which drifts over a long process) outside the window, so the work must
    not sit at its edges."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD)


def kernel_events(prof, *names) -> dict:
    """{name: (device kernels whose name holds it, their device us)} of a
    ``torch.profiler`` run, and under "all" every device kernel."""
    out = {name: [0, 0.0] for name in (*names, "all")}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us <= 0.0:
            continue
        for name in out:
            if name == "all" or name in e.key:
                out[name][0] += e.count
                out[name][1] += us
    return {k: tuple(v) for k, v in out.items()}


def phase_kernel(dev, kernel, core, masks, cfg_cls):
    """``cell_word`` against the plain word, ``lbm_steps`` against the plain
    torch step; returns the largest abs diff of each (step, word)."""
    rng = np.random.default_rng(0)
    worst = 0.0
    word_worst = 0
    for nx, ny in sorted(set(GRIDS + TILED_GRIDS)):
        cfg = cfg_cls(nx=nx, ny=ny)
        naca = masks.rasterize_airfoil(naca4_coords(), 6.0, cfg)
        for mask in (naca, edge_solid(naca)):
            solid = torch.tensor(mask, device=dev)
            before = kernel.word_launches
            word = kernel.cell_word(solid)
            want = core.cell_word(solid)
            torch.cuda.synchronize()
            require(kernel.word_launches == before + 1,
                    "word launch counter did not advance")
            diff = int((word.to(torch.int32) - want.to(torch.int32)).abs().max())
            word_worst = max(word_worst, diff)
            require(diff == 0, f"cell_word != plain at {nx}x{ny}")
    log(f"[kernel] cell_word = plain word on {len(set(GRIDS + TILED_GRIDS))} "
        f"grids x 2 masks (max abs {word_worst})")
    for nx, ny in GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                             device=dev)
        word = kernel.cell_word(solid)
        f0 = noisy_state(core, cfg, dev, rng)
        for steps in STEP_COUNTS:
            before = kernel.launches
            got = kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau, steps=steps,
                                   word=word)
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
    for _ in range(3):     # a trace may drop its one record (see traced)
        with traced() as prof:
            kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau, steps=64, word=word)
        ev = kernel_events(prof, "lbm_resident_kernel")
        log(f"[kernel] one 64-step lbm_steps call at {nx}x{ny}, profiled: "
            f"{ev['all'][0]} device kernels ({ev['lbm_resident_kernel'][0]} "
            f"lbm_resident_kernel, {ev['all'][1]:.2f} us)")
        require(ev["all"][0] == ev["lbm_resident_kernel"][0] <= 1,
                f"a 64-step lbm_steps call ran {ev}")
        if ev["all"][0] == 1:
            break
    require(ev["all"][0] == 1, "no traced call recorded its kernel")
    big = largest_resident(kernel, dev)
    for nx, ny in (PAST_CAPACITY, (big[0] + 16, big[1] + 8)):
        f = core.equilibrium_init(ny, nx, 0.06, dev)
        solid = torch.zeros((ny, nx), device=dev)
        before = (kernel.launches, kernel.word_launches)
        try:
            kernel.lbm_steps(f, solid, 0.06, 0.58, steps=4)
            raised = ""
        except ValueError as e:
            raised = str(e)
        require(raised and (kernel.launches, kernel.word_launches) == before,
                f"lbm_steps at {nx}x{ny} past capacity: {raised or 'ran'}")
        log(f"[kernel] {nx}x{ny} past capacity (largest 2:1 held: "
            f"{big[0]}x{big[1]}): ValueError, no launch: {raised}")
    return worst, float(word_worst)


def phase_tiled(dev, kernel, core, masks, cfg_cls, k):
    """Tiled kernel against the plain step and, where it holds the grid,
    ``lbm_steps``; returns the largest abs diff from the plain step."""
    rng = np.random.default_rng(0)
    limits = kernel.device_limits(dev)
    worst = 0.0
    for nx, ny in TILED_GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        naca = masks.rasterize_airfoil(naca4_coords(), 6.0, cfg)
        f0 = noisy_state(core, cfg, dev, rng)
        resident = not kernel.prefers_tiled(ny, nx, *limits)
        for mask_name, mask in (("naca", naca), ("edge-solid", edge_solid(naca))):
            solid = torch.tensor(mask, device=dev)
            word = kernel.cell_word(solid)
            for steps in (1, 3, k, 2 * k + 1, 64):
                before = kernel.tiled_launches
                got = kernel.lbm_steps_tiled(f0, solid, cfg.u0, cfg.tau,
                                             steps=steps, word=word)
                torch.cuda.synchronize()
                require(kernel.tiled_launches == before + 1,
                        f"tiled launch counter did not advance at {nx}x{ny}")
                want = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps=steps)
                diff = (got - want).abs()
                max_abs = float(diff.max())
                max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
                ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
                vs_one = 0.0
                if resident:
                    one = kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau,
                                           steps=steps, word=word)
                    vs_one = float((got - one).abs().max())
                log(f"[tiled] {nx}x{ny} {mask_name} steps={steps}: vs plain "
                    f"max_abs={max_abs:.3e} max_rel={max_rel:.3e}; vs "
                    f"lbm_steps "
                    f"{f'max_abs={vs_one:.3e}' if resident else 'past its capacity'}"
                    f" {'ok' if ok and vs_one == 0.0 else 'FAIL'}")
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
    nx, ny = largest_resident(kernel, dev)
    held = cfg_cls(nx=nx, ny=ny)
    wt_r, res = _tunnel_run(WindTunnel, dev, 10.0, held)
    wt_t, til = _tunnel_run(WindTunnel, dev, 10.0, held, tiled=True)
    log(f"[large] {nx}x{ny}, the largest 2:1 grid lbm_steps holds, alpha 10, "
        f"1500 steps: lbm_steps CL={res['cl']!r} CD={res['cd']!r}; "
        f"lbm_steps_tiled CL={til['cl']!r} CD={til['cd']!r}")
    require(not wt_r.tiled and wt_t.tiled and res["cl"] == til["cl"]
            and res["cd"] == til["cd"]
            and torch.equal(wt_r.state.f, wt_t.state.f),
            f"lbm_steps CL/CD {res['cl']}/{res['cd']} != tiled "
            f"{til['cl']}/{til['cd']} at {nx}x{ny}")
    return tiled


def _post(url: str, fields: dict, files=None):
    """multipart/form-data POST; ``files`` maps a field to (filename,
    bytes), or is a list of (field, (filename, bytes)) parts (a field may
    repeat); returns (status, json)."""
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    items = files.items() if isinstance(files, dict) else (files or [])
    for k, (fname, data) in items:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\n'
                     f'Content-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(kernel, make_server, parse_upload, build_mask, spf):
    """Drives the served /lbm/* path; returns ({kernel: its launches in the
    run}, median frame ms)."""
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
        kernel.word_launches = 0
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
        words = kernel.word_launches
        # More frames under the profiler, one trace each: the kernels a
        # frame launches. The counter shows one lbm_steps launch a frame; a
        # trace may drop a record, so up to three frames are traced, none
        # may show a tiled or word kernel or more than one resident one,
        # and one must show exactly one.
        for _ in range(3):
            before = kernel.launches
            with traced() as prof:
                status, _ = _post(url + "/lbm/frame",
                                  {"session": meta["session"],
                                   "fields": "speed"})
            require(status == 200 and kernel.launches == before + 1,
                    f"profiled /lbm/frame -> {status}")
            ev = kernel_events(prof, "lbm_resident_kernel",
                               "lbm_tiled_kernel", "cell_word_kernel")
            log(f"[server] one profiled frame: {ev['all'][0]} device "
                f"kernels, {ev['all'][1]:.1f} us; lbm_resident_kernel "
                f"{ev['lbm_resident_kernel'][0]} "
                f"({ev['lbm_resident_kernel'][1]:.2f} us), lbm_tiled_kernel "
                f"{ev['lbm_tiled_kernel'][0]}, cell_word_kernel "
                f"{ev['cell_word_kernel'][0]}")
            require(ev["lbm_resident_kernel"][0] <= 1
                    and ev["lbm_tiled_kernel"][0] == 0
                    and ev["cell_word_kernel"][0] == 0,
                    f"a served frame must launch one LBM kernel and no word "
                    f"kernel: {ev}")
            if ev["lbm_resident_kernel"][0] == 1:
                break
        require(ev["lbm_resident_kernel"][0] == 1,
                "no traced frame recorded its LBM kernel")
        status, _ = _post(url + "/lbm/stop", {"session": meta["session"]})
        require(status == 200, "/lbm/stop failed")
        status, _ = _post(url + "/lbm/frame", {"session": meta["session"]})
        require(status == 404, f"frame after stop -> {status}, want 404")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    # Words: /lbm/start builds the mask twice (the tunnel's reset, then
    # the handler's set_alpha), the alpha change once more.
    require(launches == N_FRAMES and tiled == 0 and words == 3,
            f"{launches} lbm_steps, {tiled} tiled and {words} cell_word "
            f"kernel calls for {N_FRAMES} frames and 3 masks")
    med = statistics.median(lat)
    log(f"[server] {N_FRAMES} frames at {nx}x{ny} (alpha 6 -> 10), "
        f"{launches} lbm_steps launches, {words} cell_word launches, "
        f"CL={fr['cl']} CD={fr['cd']}, median frame latency {med:.3f} ms "
        f"(HTTP round trip)")
    return {"lbm_steps": launches, "cell_word": words}, med


def device_ms(fn, n: int, name: str) -> float:
    """Device milliseconds per call of ``fn``, which launches one kernel
    whose name holds ``name``: the profiler's mean over the launches it
    recorded of ``n`` calls (it drops some records, up to half of them in
    a long process, and late in one now and then all of a window's: then
    up to two more windows are traced; the mean of those it keeps is the
    time)."""
    fn()
    for _ in range(3):
        with traced() as prof:
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
        count, us = kernel_events(prof, name)[name]
        if count:
            break
    require(1 <= count <= n, f"{count} {name} records of {n} calls")
    return us / count / 1e3


def phase_speed(dev, card, kernel, core, diagnostics, masks, cfg_cls,
                bench_mlups):
    """MLUPS, the 4-step call and the frame latency for the kernels and the
    plain step, in the order plain, kernels, kernels, plain; returns
    {kernel name: (ms, plain ms, device ms)} of the 4-step call (the mean of
    its two turns), the resident kernel's at 384x192 and the tiled kernel's
    at 2048x1024, and of ``cell_word`` at 384x192."""
    limits = kernel.device_limits(dev)
    for nx, ny in SPEED_GRIDS:
        big = nx * ny >= LARGE[0] * LARGE[1]
        # The plain step at the large grids takes fewer calls.
        plain = dict(steps_per_call=16, n_calls=2) if big else {}
        runs = [("plain", dict(kernel=False, **plain)),
                ("tiled", dict(kernel=True, tiled=True))]
        if not kernel.prefers_tiled(ny, nx, *limits):
            runs.append(("lbm_steps", dict(kernel=True, tiled=False)))
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

    call_ms = {}
    for nx, ny in ((384, 192), LARGE):
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0,
                                                     cfg), device=dev)
        word = kernel.cell_word(solid)
        f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
        spf = cfg.steps_per_frame
        steppers = {"plain": core.lbm_step,
                    "tiled": lambda *a, **k: kernel.lbm_steps_tiled(
                        *a, word=word, **k)}
        if not kernel.prefers_tiled(ny, nx, *limits):
            steppers["lbm_steps"] = lambda *a, **k: kernel.lbm_steps(
                *a, word=word, **k)
        order = list(steppers)
        for name in order + order[::-1]:
            step = steppers[name]
            n = 50 if name == "plain" else 200
            run = lambda: step(f, solid, cfg.u0, cfg.tau, steps=spf)
            ms = cuda_ms(run, n)
            kern = {"tiled": "lbm_tiled_kernel",
                    "lbm_steps": "lbm_resident_kernel"}.get(name)
            dms = device_ms(run, 20, kern) if kern else float("nan")
            call_ms.setdefault((nx, ny, name), []).append((ms, dms))
            log(f"[speed] {nx}x{ny}, one {spf}-step call, {name}: {ms:.4f} ms "
                f"(CUDA events, back-to-back calls), device time "
                f"{dms * 1e3:.2f} us (profiler) ({card})")

        def frame(step):
            def run():
                g = step(f, solid, cfg.u0, cfg.tau, steps=spf)
                cl, cd, sep = diagnostics.forces_and_separation(
                    g, solid, cfg.u0, cfg.chord_cells)
                torch.stack([cl, cd, sep]).tolist()
                diagnostics.render_fields(g, solid, cfg.u0)[0].cpu()
            return run

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

    solid = torch.tensor(masks.rasterize_airfoil(
        naca4_coords(), 6.0, cfg_cls()), device=dev)
    word_ms = cuda_ms(lambda: kernel.cell_word(solid), 200)
    word_dev = device_ms(lambda: kernel.cell_word(solid), 20,
                         "cell_word_kernel")
    word_plain = cuda_ms(lambda: core.cell_word(solid), 50)
    log(f"[speed] 384x192 cell word: cell_word {word_ms:.4f} ms (CUDA events), "
        f"device {word_dev * 1e3:.2f} us; plain {word_plain:.4f} ms ({card})")
    mean = {key: tuple(statistics.fmean(r) for r in zip(*v))
            for key, v in call_ms.items()}
    return {"lbm_steps": (mean[(384, 192, "lbm_steps")][0],
                          mean[(384, 192, "plain")][0],
                          mean[(384, 192, "lbm_steps")][1]),
            "lbm_steps_tiled": (mean[LARGE + ("tiled",)][0],
                                mean[LARGE + ("plain",)][0],
                                mean[LARGE + ("tiled",)][1]),
            "cell_word": (word_ms, word_plain, word_dev)}


# ── the XFOIL-replacement path ──────────────────────────────────────────────
def load_goldens(path: str = GOLDENS) -> dict:
    with open(path) as fh:
        return json.load(fh)


def naca_operator(code: str, dev, paneling, inviscid):
    """The port's operator for a NACA 4-digit section at ``N_PANELS``,
    from the geometry the goldens were made from."""
    coords = naca4_coords(int(code[0]), int(code[1]), int(code[2:]), 100)
    xp, yp = paneling.repanel(coords, N_PANELS, device=dev)
    return inviscid.build_operator(paneling.panel_geometry(xp, yp))


def phase_inviscid(goldens, ops, inviscid):
    worst = 0.0
    for g in goldens["inviscid"]:
        sol = inviscid.solve_inviscid(ops[g["naca"]], g["alpha"])
        cl, cm = float(sol.cl), float(sol.cm)
        dcl, dcm = abs(cl - g["cl"]), abs(cm - g["cm"])
        ok = (dcl <= 1e-4 * abs(g["cl"]) + 1e-5
              and dcm <= 1e-4 * abs(g["cm"]) + 1e-5)
        log(f"[inviscid] NACA {g['naca']} alpha={g['alpha']:g}: CL={cl!r} "
            f"(golden {g['cl']!r}, diff {dcl:.3e}) Cm={cm!r} (golden "
            f"{g['cm']!r}, diff {dcm:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"inviscid NACA {g['naca']} alpha {g['alpha']}")
        worst = max(worst, dcl, dcm)
    return worst


def _hold_march(got, want, name: str, stop=None) -> float:
    """Kernel march ``got`` against plain march ``want`` ((L, M) fields),
    lane by lane on stations [0, stop[lane]); returns the largest abs
    difference."""
    lanes, m = want.theta.shape
    worst = 0.0
    for lane in range(lanes):
        k = m if stop is None else stop[lane]
        if k == 0:
            continue
        for f in ("theta", "dstar", "hk", "cf"):
            a = getattr(got, f)[lane, :k]
            b = getattr(want, f)[lane, :k]
            d = (a - b).abs()
            worst = max(worst, float(d.max()))
            rel = d / b.abs()
            at = int(rel.argmax())
            require(bool((d <= MARCH_RTOL * b.abs()).all()),
                    f"{name} lane {lane} {f}: max rel {float(rel.max()):.3e} "
                    f"at station {at} of {k} (kernel {float(a[at])!r}, plain "
                    f"{float(b[at])!r})")
        for f in ("turb", "separated"):
            require(torch.equal(getattr(got, f)[lane, :k],
                                getattr(want, f)[lane, :k]),
                    f"{name} lane {lane}: {f} flags differ")
    return worst


def ensemble_stop(ens: dict, fields=("theta", "dstar", "turb", "separated"),
                  rtol: float = MARCH_RTOL) -> int:
    """First station at which a march's rounding ensemble spreads.

    ``ens`` maps each of ``fields`` to a (K, M) array (numpy or torch) of
    one lane's K ensemble members, the nominal member in row K // 2. A
    station spreads where a float field leaves ``rtol`` of the nominal
    member's or a flag differs from it; returns M if none does.
    """
    spread = None
    for f in fields:
        v = ens[f]
        c = v[v.shape[0] // 2]
        flag = str(v.dtype) in ("bool", "torch.bool")
        out = v != c if flag else abs(v - c) > rtol * abs(c)
        out = np.asarray(out.tolist()).any(0)
        spread = out if spread is None else spread | out
    return int(np.argmax(spread)) if spread.any() else len(spread)


@contextlib.contextmanager
def recording(mk):
    """Records (a copy of) the arguments of every ``march_side`` and
    ``march_wake`` call that reaches the kernel module ``mk``."""
    calls = {"march_side": [], "march_wake": []}
    originals = {name: getattr(mk, name) for name in calls}

    def wrap(name):
        def run(*args):
            calls[name].append([a.clone() if torch.is_tensor(a) else a
                                for a in args])
            return originals[name](*args)
        return run

    for name in calls:
        setattr(mk, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(mk, name, fn)


def _stack_calls(calls, n_arrays: int) -> list:
    """Recorded march calls as the lanes of one call: their first
    ``n_arrays`` arguments ((L, M) or (M,)) stacked, the rest (numbers or
    0-d tensors, one per call) as per-lane tensors."""
    arrays = [torch.cat([c[i].reshape(-1, c[i].shape[-1]) for c in calls])
              for i in range(n_arrays)]
    params = []
    for i in range(n_arrays, len(calls[0])):
        params.append(torch.cat([
            torch.as_tensor(c[i], dtype=torch.float32, device=c[0].device)
            .expand(c[0].reshape(-1, c[0].shape[-1]).shape[0])
            for c in calls]))
    return [a.contiguous() for a in arrays + params]


def _rows(bl, rows):
    return type(bl)(*(a[rows] for a in bl))


def _same_bits(xs, ys) -> bool:
    """Equal bit for bit (NaNs included), tensor by tensor."""
    bits = lambda a: a.view(torch.int32) if a.dtype == torch.float32 else a
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(xs, ys))


def _flat_plate_lanes(dev):
    n = len(FLAT_PLATE)
    s = torch.linspace(0.004, 1.0, 120, device=dev).expand(n, -1).contiguous()
    re, n_crit, x_trip = (torch.tensor(c, device=dev)
                          for c in zip(*FLAT_PLATE))
    return s, torch.ones_like(s), s, 1.0 / re, n_crit, x_trip


def _airfoil_sides(op, coupled, inviscid, alphas=(0.0, 5.0)):
    """The section's two sides at each of ``alphas`` from the port's own
    inviscid solve on the card: (s, ue, x) of 2 x len(alphas) lanes of 80
    stations, upper then lower."""
    pan = op.pan
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s_le = pan.s[torch.argmin(pan.xp)]
    rows = []
    for alpha in alphas:
        vt = inviscid.solve_inviscid(op, alpha).vt
        s0 = coupled._find_stagnation(s_mid, vt, s_le)
        for upper in (True, False):
            xi, _, ue, x, _ = coupled._side_stations(pan, vt, s0, upper, 80)
            rows.append((xi, ue, x))
    return [torch.stack(c).contiguous() for c in zip(*rows)]


def phase_march(dev, mk, plain, coupled, inviscid, op, trip_x):
    """The march kernel against the plain march, on made-up lanes, on the
    NACA 2412 sides and on the inputs the main path gives it; then the
    physics anchors on the kernel alone. Returns ({kernel: largest abs
    difference}, the free airfoil sides, the batch of 1,914 side lanes)."""
    before, before_w = mk.march_launches, mk.wake_launches
    args = _flat_plate_lanes(dev)
    t0 = time.perf_counter()
    want = plain.march_side(*args)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    got = mk.march_side(*args)
    torch.cuda.synchronize()
    worst = _hold_march(got, want, "flat plate")
    require(torch.equal(got.x_transition, want.x_transition),
            f"flat plate x_transition {got.x_transition.tolist()} != "
            f"{want.x_transition.tolist()}")
    log(f"[march] flat plate, 5 lanes x 120 stations: kernel = plain "
        f"(rtol {MARCH_RTOL}, flags and x_transition identical), max abs "
        f"{worst:.3e}; x_tr {got.x_transition.tolist()}; plain call "
        f"{t_plain:.2f} s")

    # The main path's own inputs: every march call of a default solve
    # tripped at trip_x and of a free one, as they reached the kernel;
    # with them, as two more calls of 4 lanes, the NACA 2412 sides at alpha
    # 0 and 5 tripped at trip_x and free. The tripped solve's side marches
    # and the tripped sides are strict (no laminar knife edge; a main-path
    # lane's last station may leave the Newton unconverged where ue falls
    # steeply into the trailing edge), the free sides are held up to where
    # the plain march's own ensemble spreads.
    with recording(mk) as calls:
        coupled.solve_viscous(op, 5.0, 1e6, x_forced_transition=trip_x)
        n_trip = len(calls["march_side"])
        n_trip_w = len(calls["march_wake"])
        coupled.solve_viscous(op, 5.0, 1e6)
    sides = _airfoil_sides(op, coupled, inviscid)
    full = lambda v: torch.full((sides[0].shape[0],), v, device=dev)
    naca = lambda xf: [*sides, full(1e-6), full(9.0), full(xf)]
    held, batch = hold_recorded_marches(
        dev, mk, plain,
        [naca(trip_x)] + calls["march_side"][:n_trip] + [naca(1.0)],
        calls["march_wake"], 1 + n_trip, n_trip_w,
        f"NACA 2412 sides tripped at {trip_x}, the tripped default "
        f"solve_viscous's side marches, the free sides; both solves' wakes",
        te_tail=1, stage="march")
    worst = max(worst, held["bl_march"])
    worst_w = held["bl_march_wake"]

    # Physics anchors (tests/test_viscous.py:24-116) on the kernel alone.
    fp = mk.march_side(*args)
    theta_exact = 0.664 / np.sqrt(1e6)
    require(abs(float(fp.theta[0, -1]) - theta_exact) / theta_exact < 0.02
            and abs(float(fp.hk[0, -1]) - 2.59) < 0.02, "Blasius anchor")
    require(0.0028 < float(fp.cf[1, -1]) < 0.0046
            and 1.25 < float(fp.hk[1, -1]) < 1.55, "tripped plate anchor")
    for lane, re in ((2, 6e6), (3, 1e7)):
        require(2.5e6 < re * float(fp.x_transition[lane]) < 3.6e6,
                f"transition Re_x at Re {re:g}")
    require(float(fp.x_transition[4]) >= 0.99, "no transition at Re 2e5")
    sw = torch.linspace(0.01, 1.0, 40, device=dev)
    got_w = mk.march_wake(sw, torch.full_like(sw, 0.9), 1e-6, 0.004, 0.008,
                          0.002)
    xf = torch.linspace(1e-3, 1.0, 256, device=dev)
    ue_fs = torch.stack([xf ** (b / (2.0 - b)) for b, _ in FALKNER_SKAN])
    fs = mk.march_side(xf.expand(len(FALKNER_SKAN), -1).contiguous(), ue_fs,
                       xf.expand(len(FALKNER_SKAN), -1).contiguous(),
                       1.0 / 5e5, 1e9, 2.0)
    hk_fs = (fs.dstar / fs.theta.clamp(min=1e-12))[:, 256 // 3: 2 * 256 // 3]
    for i, (beta, h_ref) in enumerate(FALKNER_SKAN):
        h = float(hk_fs[i].median())
        require(abs(h - h_ref) / h_ref < 0.01, f"Falkner-Skan beta {beta}")
    require(abs(float(got_w[0][-1]) - 0.004) <= 1e-3 * 0.004
            and float(got_w[2][-1]) < 1.3, "wake anchor")
    log(f"[march] physics on the kernel: Blasius theta "
        f"{float(fp.theta[0, -1]):.6e} (exact {theta_exact:.6e}), Re_x_tr "
        f"{6e6 * float(fp.x_transition[2]):.4g} and "
        f"{1e7 * float(fp.x_transition[3]):.4g}, Falkner-Skan H "
        f"{[round(float(h.median()), 4) for h in hk_fs]}, wake theta "
        f"{float(got_w[0][-1]):.6e}")
    require(mk.march_launches > before and mk.wake_launches > before_w,
            "march launch counters did not move")
    return {"bl_march": worst, "bl_march_wake": worst_w}, sides, batch


def held_to_members(rec: dict, golden: dict, bars=None) -> list:
    """What fails when ``rec`` is held to a Newton golden point: its
    ``converged`` must be one of the rounding ensemble's, and each barred
    field must lie within its bar of the range over the ensemble members
    that share that ``converged`` (a member off in another basin widens
    the range of only its own verdict)."""
    bars = VISCOUS_BARS if bars is None else bars
    members = [m for m in golden["members"]
               if m["converged"] == rec["converged"]]
    if not members:
        return [f"converged {rec['converged']} not among the ensemble's "
                f"{golden['ensemble']['converged']}"]
    fails = []
    for f, (abs_bar, rel_bar) in bars.items():
        lo = min(m[f] for m in members)
        hi = max(m[f] for m in members)
        if not (lo - abs_bar - rel_bar * abs(lo) <= rec[f]
                <= hi + abs_bar + rel_bar * abs(hi)):
            fails.append(f"{f} {rec[f]!r} outside [{lo}, {hi}] +- bar")
    return fails


def merged_record(out) -> dict:
    """A polar-point answer ((cl, cd, cdp, cm, converged, xtr_u, xtr_l,
    sep), (newton_converged, state)) as the golden record's fields."""
    merged, (nok, _state) = out
    names = ("cl", "cd", "cdp", "cm", "converged", "xtr_upper", "xtr_lower",
             "sep_fraction")
    rec = {f: (bool(v) if f == "converged" else float(v))
           for f, v in zip(names, merged)}
    rec["newton_converged"] = bool(nok)
    return rec


def _viscous_record(r) -> dict:
    return {"cl": float(r.cl), "cd": float(r.cd), "cdp": float(r.cdp),
            "cm": float(r.cm), "converged": bool(r.converged),
            "xtr_upper": float(r.upper.x_transition),
            "xtr_lower": float(r.lower.x_transition),
            "sep_fraction": float(r.sep_fraction)}


def phase_viscous(goldens, ops, coupled, mk):
    """The main path of this slice: default ``solve_viscous`` at the golden
    points, free and tripped; returns ({(section, alpha): free result},
    {kernel: its launches in the run})."""
    mk.march_launches = 0
    mk.wake_launches = 0
    results = {}
    points = [(g, {}, g["ensemble"]) for g in goldens["viscous"]]
    # Tripped near the leading edge the reference is no knife edge: held
    # to its nominal run, ``converged`` equal.
    points += [(g, {"x_forced_transition": goldens["trip_x"]},
                {**{f: [g[f], g[f]] for f in VISCOUS_BARS},
                 "converged": [g["converged"]]})
               for g in goldens["tripped"]]
    for g, kw, ens in points:
        before = mk.march_launches, mk.wake_launches
        t0 = time.perf_counter()
        r = coupled.solve_viscous(ops[g["naca"]], g["alpha"], g["re"], **kw)
        rec = _viscous_record(r)
        secs = time.perf_counter() - t0
        if not kw:
            results[g["naca"], g["alpha"]] = r
        n_side = mk.march_launches - before[0]
        n_wake = mk.wake_launches - before[1]
        n = n_side + n_wake
        fails = []
        for f, (abs_bar, rel_bar) in VISCOUS_BARS.items():
            lo, hi = ens[f]
            if not (lo - abs_bar - rel_bar * abs(lo) <= rec[f]
                    <= hi + abs_bar + rel_bar * abs(hi)):
                fails.append(f"{f} {rec[f]!r} outside [{lo}, {hi}]")
        if rec["converged"] not in ens["converged"]:
            fails.append(f"converged {rec['converged']}")
        if g["alpha"] >= 16.0 and rec["converged"]:
            fails.append("alpha 16 converged")
        trip = f", tripped at {kw['x_forced_transition']}" if kw else ""
        log(f"[viscous] NACA {g['naca']} alpha={g['alpha']:g} Re={g['re']:g}"
            f"{trip}: {json.dumps(rec)}; golden "
            f"{json.dumps({f: g[f] for f in rec})}; held to "
            f"{json.dumps(ens)}; {n} march launches, {secs:.3f} s "
            f"{'ok' if not fails else 'FAIL ' + str(fails)}")
        require(not fails, f"viscous NACA {g['naca']} alpha {g['alpha']}"
                f"{trip}: {fails}")
        require(n_side == 25 and n_wake == 25,
                f"{n_side} side and {n_wake} wake march launches, want "
                f"24 + 1 each")
    return results, {"bl_march": mk.march_launches,
                     "bl_march_wake": mk.wake_launches}


def phase_viscous_anchors(results, ops, coupled, inviscid, mk):
    """The slow-tier anchors of ``tests/test_viscous.py:131-196`` on the
    card, from the viscous phase's solves and three more (Re trend,
    forced transition)."""
    r0, r5 = results["2412", 0.0], results["2412", 5.0]
    z, p, m = (results["0012", a] for a in (0.0, 4.0, -4.0))
    f = float
    require(bool(r0.converged) and abs(f(r0.cl) - 0.24) < 0.04
            and 0.0050 < f(r0.cd) < 0.0080
            and 0.45 < f(r0.upper.x_transition) < 0.75, "2412 alpha 0 anchor")
    require(abs(f(r5.cl) - 0.755) < 0.08 and 0.0050 < f(r5.cd) < 0.0105
            and 0.15 < f(r5.upper.x_transition) < 0.45, "2412 alpha 5 anchor")
    cl_inv = f(inviscid.solve_inviscid(ops["2412"], 5.0).cl)
    require(f(r5.cl) < cl_inv, "viscous CL must be below inviscid")
    require(abs(f(p.cl) + f(m.cl)) < 0.03 and abs(f(z.cl)) < 0.01
            and 0.0045 < f(z.cd) < 0.0080, "symmetric 0012 anchor")
    require(not bool(results["0012", 16.0].converged),
            "0012 alpha 16 must not converge")
    for side in (r5.upper, r5.lower):
        require(bool((side.theta > 0).all())
                and bool((side.dstar >= side.theta * 0.99).all()),
                "2412 alpha 5 boundary-layer sanity")
    require(f(r5.upper.x_transition) < f(r5.lower.x_transition),
            "upper transition must lead at alpha 5")
    before = mk.march_launches + mk.wake_launches
    cd_lo = f(coupled.solve_viscous(ops["0012"], 0.0, 5e5).cd)
    cd_hi = f(coupled.solve_viscous(ops["0012"], 0.0, 5e6).cd)
    trip = coupled.solve_viscous(ops["0012"], 0.0, 1e6,
                                 x_forced_transition=0.1)
    n = mk.march_launches + mk.wake_launches - before
    require(n == 150, f"{n} march launches for 3 solves")
    require(cd_hi < cd_lo, f"CD must fall with Re: {cd_lo} -> {cd_hi}")
    require(f(trip.upper.x_transition) < 0.2 and f(trip.cd) > f(z.cd),
            "forced transition anchor")
    log(f"[viscous] slow-tier anchors hold: 2412 CL {f(r0.cl):.4f} / "
        f"{f(r5.cl):.4f} (inviscid {cl_inv:.4f} at alpha 5), 0012 CL(+4) + "
        f"CL(-4) {f(p.cl) + f(m.cl):.2e}, CD(Re 5e5) {cd_lo:.5f} > "
        f"CD(5e6) {cd_hi:.5f}, tripped at 0.1: x_tr "
        f"{f(trip.upper.x_transition):.4f}, CD {f(trip.cd):.5f} > "
        f"{f(z.cd):.5f}")


def _median_s(fn, n: int = 10) -> float:
    t = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return statistics.median(t)


def side_march_bound(mk, plain, args) -> tuple:
    """((ms, what bounds it), operations) of one side march call ``args``
    (s, ue, x, then nu and the other per-lane parameters): its arrays and
    three per-lane parameters read once and its outputs written once; the
    operations of the plain march, which does the same at every interval,
    counted over PROFILED_INTERVALS of them and scaled to the call's."""
    s, ue, x, *params = args
    out = mk.march_side(*args)
    n_lanes, m = s.shape
    cut = [a[..., :PROFILED_INTERVALS + 1].contiguous() for a in (s, ue, x)]
    ops = count_ops(plain.march_side, *cut, *params) \
        * (m - 1) / PROFILED_INTERVALS
    return bound(nbytes(s, ue, x, *out) + 3 * 4 * n_lanes, ops), ops


def wake_march_bound(mk, plain, w) -> tuple:
    """As ``side_march_bound``, for one wake march call ``w`` (s, ue, nu,
    theta0, dstar0, ctau0): its four per-lane parameters read once."""
    mw = w[0].shape[-1]
    out = mk.march_wake(*w)
    cut = [w[0][..., :PROFILED_INTERVALS + 1],
           w[1][..., :PROFILED_INTERVALS + 1], *w[2:]]
    ops = count_ops(plain.march_wake, *cut) * (mw - 1) / PROFILED_INTERVALS
    lanes = w[0].reshape(-1, mw).shape[0]
    return bound(nbytes(*w[:2], *out) + 4 * 4 * lanes, ops), ops


def phase_viscous_speed(card, ops, inviscid, coupled, wake, mk, plain, sides,
                        batch):
    """Default solve and its split; one side-pair march at 80 stations and
    one 24-station wake march with the kernels and the plain march; the
    side kernel at 1, 2, 62 and 1,914 lanes. Returns ({kernel: (kernel ms,
    plain ms, device ms), each at its main-path shape}, {kernel: (bound ms,
    what bounds it)})."""
    op = ops["2412"]
    pan = op.pan
    coupled.solve_viscous(op, 5.0, 1e6)            # warm
    t_op = _median_s(lambda: inviscid.build_operator(pan))
    t_wake = _median_s(lambda: wake.build_wake_operator(op, 5.0, n_wake=24))
    t_solve = _median_s(lambda: coupled.solve_viscous(op, 5.0, 1e6))
    t_one = _median_s(lambda: coupled.solve_viscous(op, 5.0, 1e6,
                                                    coupling_iters=1))
    t_pass = (t_solve - t_one) / 23.0
    log(f"[viscous speed] NACA 2412 alpha 5 Re 1e6, default solve_viscous "
        f"(160 panels, 80/24/24), median of 10, synchronised: "
        f"{t_solve * 1e3:.3f} ms; build_operator {t_op * 1e3:.3f} ms; "
        f"build_wake_operator {t_wake * 1e3:.3f} ms; one coupling pass "
        f"{t_pass * 1e3:.3f} ms (from the 24- and 1-pass solves, "
        f"{t_one * 1e3:.3f} ms) ({card})")

    with traced() as prof:
        coupled.solve_viscous(op, 5.0, 1e6)
    events = prof.key_averages()
    dev_us = {"march_side": 0.0, "march_wake": 0.0, "all": 0.0}
    for e in events:
        us = getattr(e, "device_time_total", 0.0)
        dev_us["all"] += us
        for name in ("march_side", "march_wake"):
            if f"{name}_kernel" in e.key:
                dev_us[name] += us
    log(f"[viscous speed] profiled default solve: "
        f"{sum(e.count for e in events)} device operations, "
        f"{dev_us['all'] / 1e3:.3f} ms of device time, of which "
        f"march_side_kernel {dev_us['march_side'] / 1e3:.3f} ms and "
        f"march_wake_kernel {dev_us['march_wake'] / 1e3:.3f} ms; device "
        f"busy {dev_us['all'] / 1e3 / (t_solve * 1e3):.1%} of the median "
        f"solve's wall time ({card})")

    s, ue, x = (a[2:].contiguous() for a in sides)    # alpha 5 side pair
    k_ms = cuda_ms(lambda: mk.march_side(s, ue, x, 1e-6), 50)
    k_dev = device_ms(lambda: mk.march_side(s, ue, x, 1e-6), 20,
                      "march_side_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_side(s, ue, x, 1e-6)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # The plain march issues the same operations at every station, so the
    # profiler traces its first PROFILED_INTERVALS intervals only (a whole
    # call is ~2 M device operations).
    cut = [a[:, :PROFILED_INTERVALS + 1].contiguous() for a in (s, ue, x)]
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plain.march_side(*cut, 1e-6)
        torch.cuda.synchronize()
    events = prof.key_averages()
    n_dev = sum(e.count for e in events)
    dev_us = sum(getattr(e, "device_time_total", 0.0) for e in events)
    per = n_dev / PROFILED_INTERVALS
    log(f"[viscous speed] one side-pair march, 2 lanes x 80 stations: "
        f"kernel {k_ms:.4f} ms (CUDA events, mean of 50; device "
        f"{k_dev:.4f} ms); plain {plain_ms:.1f}"
        f" ms (one call, host clock, synchronised); profiled plain march of "
        f"{PROFILED_INTERVALS} intervals: {n_dev} device operations "
        f"({per:.0f} a station interval, so {per * 79:.0f} for the 79 of the "
        f"call), {dev_us / 1e3:.2f} ms of device time; profiling took "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    # The side kernel's time against its lane count: one block per lane, so
    # lanes run side by side until they share the SMs' issue slots.
    polar = _airfoil_sides(op, coupled, inviscid, POLAR_ALPHAS)
    cases = {"upper side (1 lane)": [a[2:3] for a in sides] + [1e-6],
             "lower side (1 lane)": [a[3:4] for a in sides] + [1e-6],
             "side pair (2 lanes)": [s, ue, x, 1e-6],
             f"{len(POLAR_ALPHAS)}-point polar's sides "
             f"({2 * len(POLAR_ALPHAS)} lanes)": polar + [1e-6],
             f"march phase batch ({batch[0].shape[0]} lanes)": batch}
    lane_ms = {}
    for name, args in cases.items():
        args = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        lane_ms[name] = cuda_ms(lambda: mk.march_side(*args), 50)
    log(f"[viscous speed] march_side_kernel at 80 stations (CUDA events, mean "
        f"of 50): " + "; ".join(f"{n} {t:.4f} ms" for n, t in lane_ms.items())
        + f"; {2 * len(POLAR_ALPHAS)} lanes / 2 lanes "
        f"{list(lane_ms.values())[3] / k_ms:.3f} ({card})")

    # The wake march of the default solve's last pass.
    with recording(mk) as calls:
        coupled.solve_viscous(op, 5.0, 1e6)
    w = calls["march_wake"][-1]
    w_ms = cuda_ms(lambda: mk.march_wake(*w), 50)
    w_dev = device_ms(lambda: mk.march_wake(*w), 20, "march_wake_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_wake(*w)
    torch.cuda.synchronize()
    w_plain_ms = (time.perf_counter() - t0) * 1e3
    mw = w[0].shape[-1]
    log(f"[viscous speed] one wake march, 1 lane x {mw} stations: kernel "
        f"{w_ms:.4f} ms (CUDA events, mean of 50; device {w_dev:.4f} ms); "
        f"plain {w_plain_ms:.1f} ms "
        f"(one call, host clock) ({card})")

    side_bound, side_ops = side_march_bound(mk, plain, [s, ue, x, 1e-6])
    wake_bound, wake_ops = wake_march_bound(mk, plain, w)
    log(f"[viscous speed] bounds: side pair {side_bound[0] * 1e3:.3f} us "
        f"({side_ops:.4g} operations), wake {wake_bound[0] * 1e3:.3f} us "
        f"({wake_ops:.4g} operations), set by {side_bound[1]} and "
        f"{wake_bound[1]}")
    return ({"bl_march": (k_ms, plain_ms, k_dev),
             "bl_march_wake": (w_ms, w_plain_ms, w_dev)},
            {"bl_march": side_bound, "bl_march_wake": wake_bound})


# ── the simultaneous-Newton path ────────────────────────────────────────────
NEWTON_POINT = ("2412", 4.0, 1e6)          # the speed phase's point
TE_TAIL = 5     # trailing-edge stations where a tripped march may spread
# The fields a march lane is held on: a station is held while the plain
# march's rounding ensemble stays within MARCH_RTOL in each of them (cf
# nears zero at separation, where only the ensemble tells rounding from
# error).
HELD_FIELDS = ("theta", "dstar", "hk", "cf", "turb", "separated")
# solve_viscous_newton's defaults: stations a side, wake stations, warm
# passes, LM iterations a round.
NEWTON_SHAPE = {"n_stations": 96, "n_wake": 20, "warm_iters": 8,
                "newton_iters": 12}


def hold_recorded_marches(dev, mk, plain, side_calls, wake_calls,
                          n_strict_sides, n_strict_wakes, label,
                          te_tail=TE_TAIL, stage="newton march",
                          xtr_between=False):
    """The march kernels against the plain march on recorded main-path
    calls: all side calls as the lanes of one batch, all wake calls as
    those of another, each lane with the plain march's rounding ensemble
    (ue scaled by 1 + k 2^-23). A lane is held (rtol MARCH_RTOL, flags
    identical) up to the first station where its ensemble spreads, and its
    x_transition must be one of the ensemble's (with ``xtr_between``, where
    the ensemble's takes several values, anywhere between the least and
    the greatest of them: a free lane at a laminar knife edge, whose
    rounding moves transition by stations); the lanes of the first
    ``n_strict_sides`` side calls (tripped: no laminar knife edge) must
    have one x_transition over the ensemble and may spread only in their
    last ``te_tail`` stations, where ue falls steeply into the trailing
    edge, those of the first ``n_strict_wakes`` wake calls not at all.
    Each call is also launched at its own shape and must equal its lanes
    of the batch bit for bit. Returns ({kernel: largest abs difference},
    the batch of side lanes)."""
    k = len(ENSEMBLE_K)
    scale = (1.0 + torch.tensor(ENSEMBLE_K, dtype=torch.float64)
             * 2.0 ** -23).float().to(dev)

    def ensemble(lanes):
        n = lanes[0].shape[0]
        batch = [a.repeat_interleave(k, 0) for a in lanes]
        batch[1] = batch[1] * scale.repeat(n)[:, None]
        return [a.contiguous() for a in batch], n

    batch, n_l = ensemble(_stack_calls(side_calls, 3))
    m = batch[0].shape[1]
    t0 = time.perf_counter()
    want = plain.march_side(*batch)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    got = mk.march_side(*batch)
    torch.cuda.synchronize()
    nominal = torch.arange(n_l, device=dev) * k + k // 2
    strict = sum(c[0].reshape(-1, m).shape[0]
                 for c in side_calls[:n_strict_sides])
    stop = []
    between = 0
    for lane in range(n_l):
        rows = slice(lane * k, (lane + 1) * k)
        stop.append(ensemble_stop({f: getattr(want, f)[rows]
                                   for f in HELD_FIELDS}, HELD_FIELDS))
        xtrs = set(want.x_transition[rows].tolist())
        xk = float(got.x_transition[nominal[lane]])
        if xtr_between and xk not in xtrs and len(xtrs) > 1 \
                and min(xtrs) <= xk <= max(xtrs):
            between += 1
        else:
            require(xk in xtrs, f"{label} side lane {lane}: x_tr {xk} not "
                    f"in the plain ensemble's {sorted(xtrs)}")
        require(lane >= strict or (len(xtrs) == 1 and stop[-1] >= m - te_tail),
                f"{label}: strict side lane {lane}: the plain ensemble "
                f"spreads from station {stop[-1]} of {m}, x_tr {sorted(xtrs)}")
    own = type(got)(*(torch.cat(f) for f in zip(*(
        mk.march_side(*c) for c in side_calls))))
    require(_same_bits(own, _rows(got, nominal)),
            f"{label}: a side march at its own shape differs from its lanes "
            f"of the batch")
    worst = _hold_march(own, _rows(want, nominal), f"{label} sides", stop)

    wb, n_wl = ensemble(_stack_calls(wake_calls, 2))
    mw = wb[0].shape[1]
    want_w = plain.march_wake(*wb)
    got_w = mk.march_wake(*wb)
    torch.cuda.synchronize()
    wstop = [ensemble_stop({"theta": want_w[0][lane * k:(lane + 1) * k],
                            "dstar": want_w[1][lane * k:(lane + 1) * k]},
                           ("theta", "dstar")) for lane in range(n_wl)]
    require(all(t == mw for t in wstop[:n_strict_wakes]),
            f"{label}: strict wakes spread at {wstop[:n_strict_wakes]}")
    own_w = [torch.cat(f) for f in zip(*(
        [a.reshape(-1, mw) for a in mk.march_wake(*c)] for c in wake_calls))]
    w_rows = torch.arange(n_wl, device=dev) * k + k // 2
    require(_same_bits(own_w, [a[w_rows] for a in got_w]),
            f"{label}: a wake march at its own shape differs from its lane "
            f"of the batch")
    worst_w = 0.0
    for lane, stop_l in enumerate(wstop):
        for a, b, f in zip(own_w, want_w, ("theta", "dstar", "hk")):
            a, b = a[lane, :stop_l], b[w_rows[lane], :stop_l]
            d = (a - b).abs()
            worst_w = max(worst_w, float(d.max()) if d.numel() else 0.0)
            require(bool((d <= MARCH_RTOL * b.abs()).all()),
                    f"{label} wake lane {lane} {f}: max rel "
                    f"{float((d / b.abs()).max()):.3e}")
    log(f"[{stage}] {label}: {len(side_calls)} side marches ({n_l} "
        f"lanes x {m} stations) and {len(wake_calls)} wake marches ({mw} "
        f"stations), each with its plain rounding ensemble of {k} and "
        f"launched alone at its own shape (bit-equal to the batch): side "
        f"lanes spread-free on all stations {sum(t == m for t in stop)} of "
        f"{n_l} (else held up to {[t for t in stop if t < m]}), wakes "
        f"{sum(t == mw for t in wstop)} of {n_wl}; kernel = plain there "
        f"(rtol {MARCH_RTOL}, flags and x_transition in the ensemble; "
        f"{between} knife-edge lanes' x_transition between the ensemble's "
        f"values), max "
        f"abs {worst:.3e} (sides), {worst_w:.3e} (wakes); plain batch call "
        f"{t_plain:.2f} s")
    return {"bl_march": worst, "bl_march_wake": worst_w}, batch


def phase_newton_march(dev, mk, plain, newton, op, trip_x):
    """Every march of a tripped and a free default Newton solve (NACA 2412,
    the speed point) against the plain march; returns ({kernel: largest abs
    difference}, one side call and one wake call of the free solve)."""
    code, alpha, re = NEWTON_POINT
    with recording(mk) as calls:
        newton.solve_viscous_newton(op, alpha, re,
                                    x_forced_transition=trip_x)
        n_trip, n_trip_w = len(calls["march_side"]), len(calls["march_wake"])
        newton.solve_viscous_newton(op, alpha, re)
    per = NEWTON_SHAPE["warm_iters"] + 2
    require(len(calls["march_side"]) == 2 * per
            and len(calls["march_wake"]) == 2,
            f"{len(calls['march_side'])} side and {len(calls['march_wake'])} "
            f"wake marches in two Newton solves, want {2 * per} and 2")
    worst, _batch = hold_recorded_marches(
        dev, mk, plain, calls["march_side"], calls["march_wake"], n_trip,
        n_trip_w, f"NACA {code} alpha {alpha:g} Newton solves tripped at "
        f"{trip_x} and free")
    return worst, calls["march_side"][n_trip], calls["march_wake"][-1]


def _held(label, rec, golden, n_side, n_wake, want_side, secs):
    fails = held_to_members(rec, golden)
    if (n_side, n_wake) != (want_side, 1):
        fails.append(f"{n_side} side and {n_wake} wake march launches, want "
                     f"{want_side} and 1")
    log(f"[newton] {label}: {json.dumps(rec)}; golden "
        f"{json.dumps({f: golden[f] for f in rec})}; ensemble "
        f"{json.dumps(golden['ensemble'])}; {n_side} + {n_wake} march "
        f"launches, {secs:.3f} s {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"{label}: {fails}")


def phase_newton(dev, goldens, ops, newton, mk):
    """The main path of this slice's solver: the default Newton solve at
    each golden point, the polar point and both continuation solves from
    the reference's donor state; returns {kernel: its launches}."""
    mk.march_launches = 0
    mk.wake_launches = 0
    per = NEWTON_SHAPE["warm_iters"] + 2

    def run(fn):
        before = mk.march_launches, mk.wake_launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, mk.march_launches - before[0],
                mk.wake_launches - before[1], time.perf_counter() - t0)

    for g in goldens["newton"]:
        r, n_s, n_w, secs = run(lambda: newton.solve_viscous_newton(
            ops[g["naca"]], g["alpha"], g["re"]))
        _held(f"solve_viscous_newton NACA {g['naca']} alpha {g['alpha']:g}",
              _viscous_record(r), g, n_s, n_w, per, secs)
    c = goldens["continuation"]["default"]
    op = ops[c["naca"]]
    out, n_s, n_w, secs = run(lambda: newton.solve_polar_point(
        op, c["donor_alpha"], c["re"]))
    _held(f"solve_polar_point alpha {c['donor_alpha']:g}", merged_record(out),
          c["donor"], n_s, n_w, per, secs)
    st = c["donor"]["state"]
    donor = newton.state_from_numpy(st["zz"], st["xtr_u"], st["xtr_l"],
                                    device=dev)
    r, n_s, n_w, secs = run(lambda: newton.solve_viscous_newton_cont(
        op, c["cont_alpha"], c["re"], *donor))
    _held(f"solve_viscous_newton_cont alpha {c['donor_alpha']:g} -> "
          f"{c['cont_alpha']:g} from the reference's donor",
          _viscous_record(r), c["solve_viscous_newton_cont"], n_s, n_w, 3,
          secs)
    out, n_s, n_w, secs = run(lambda: newton.solve_polar_point_cont(
        op, c["cont_alpha"], c["re"], *donor))
    _held(f"solve_polar_point_cont alpha {c['donor_alpha']:g} -> "
          f"{c['cont_alpha']:g} from the reference's donor",
          merged_record(out), c["solve_polar_point_cont"], n_s, n_w, 3, secs)
    return {"bl_march": mk.march_launches, "bl_march_wake": mk.wake_launches}


def newton_system(dev, newton, op, alphas=None):
    """The Newton system at the speed point (or at ``alphas``, one lane
    each) after its warm start, the start state (P, n3) and the start
    damping (P,)."""
    code, alpha, re = NEWTON_POINT
    if alphas is not None:
        alpha = torch.tensor(alphas, dtype=torch.float32, device=dev)
    system, _sc, _ws, zz = newton._prepare(
        op, alpha, re, 9.0, 1.0, NEWTON_SHAPE["n_stations"],
        NEWTON_SHAPE["n_wake"], NEWTON_SHAPE["warm_iters"])
    return system, zz, torch.full((zz.shape[0],), 1e-3, device=dev)


def phase_lm_sync_free(dev, newton, op):
    """One LM iteration at the speed point, and one of eight lanes (a
    polar bucket's), under ``torch.cuda.set_sync_debug_mode("error")``:
    neither may synchronise with the host (after one warm iteration, which
    fills the device constant caches)."""
    for alphas in (None, [-2.0, 0.0, 2.0, 4.0, 6.0, 6.0, 6.0, 6.0]):
        system, zz, lam = newton_system(dev, newton, op, alphas)
        system.lm_step(zz, lam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            zz2, lam2 = system.lm_step(zz, lam)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(zz2).all()) and bool((lam2 > 0.0).all()),
                "LM iteration result")
        log(f"[newton] one LM iteration ({zz.shape[0]} lane(s) of "
            f"{zz.shape[-1]} unknowns) ran under set_sync_debug_mode("
            f"'error'): no host synchronisation; damping "
            f"{lam.tolist()} -> {lam2.tolist()}")


@contextlib.contextmanager
def recorded_solvers(analyze_mod):
    """Records (solver, alpha, converged) of every solver call that
    ``analyze_airfoil`` makes."""
    calls = []
    names = ("solve_viscous_newton", "solve_polar_point",
             "solve_polar_point_cont", "solve_viscous_newton_cont",
             "solve_viscous")
    originals = {n: getattr(analyze_mod, n) for n in names}

    def wrap(name, fn):
        def run(op, alpha, *args, **kwargs):
            out = fn(op, alpha, *args, **kwargs)
            conv = out[1][0] if name in ("solve_polar_point",
                                         "solve_polar_point_cont") \
                else out.converged
            calls.append([name, float(alpha), bool(conv)])
            return out
        return run

    for n, fn in originals.items():
        setattr(analyze_mod, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(analyze_mod, n, fn)


def _coefficients_held(c: dict, ens: dict) -> list:
    fails = []
    for key, f, (abs_bar, rel_bar) in (("CL", "cl", VISCOUS_BARS["cl"]),
                                       ("CD", "cd", VISCOUS_BARS["cd"]),
                                       ("Cm", "cm", VISCOUS_BARS["cm"])):
        lo, hi = ens[f]
        if not (lo - abs_bar - rel_bar * abs(lo) <= c[key]
                <= hi + abs_bar + rel_bar * abs(hi)):
            fails.append(f"{key} {c[key]} outside [{lo}, {hi}] +- bar")
    if c["mode"] not in ens["mode"]:
        fails.append(f"mode {c['mode']} not in {ens['mode']}")
    return fails


def _bl_schema(bl: dict, n: int) -> bool:
    row = {"x", "y", "dstar", "theta", "cf", "H"}
    return (set(bl) == {"upper", "lower", "transition_upper_x",
                        "transition_lower_x"}
            and len(bl["upper"]) == len(bl["lower"]) == n
            and all(set(r) == row for r in bl["upper"] + bl["lower"])
            and bl["upper"][0]["x"] > bl["upper"][-1]["x"]
            and bl["lower"][0]["x"] < bl["lower"][-1]["x"]
            and all(np.isfinite([r[k] for k in row]).all()
                    for r in bl["upper"] + bl["lower"]))


def phase_analyze(dev, goldens, polar, analyze_mod):
    """``analyze_airfoil`` on the card at golden (d)'s alphas; returns
    {alpha: wall seconds}."""
    walls = {}
    for g in goldens["analyze"]:
        with recorded_solvers(analyze_mod) as calls:
            t0 = time.perf_counter()
            res = polar.analyze_airfoil(naca4_coords(2, 4, 12, g["coords"]),
                                        g["re"], g["alpha"], device=dev)
            walls[g["alpha"]] = time.perf_counter() - t0
        c = res.coefficients
        fails = []
        if g["mode"] == "inviscid":
            if (res.mode, res.strategy, res.bl_data) != ("inviscid", 3, None):
                fails.append(f"mode {res.mode} strategy {res.strategy}")
            if c.get("warning") != polar.INVISCID_WARNING or c["CD"] != 0.0:
                fails.append(f"coefficients {c}")
            for key in ("CL", "Cm"):
                if abs(c[key] - g["coefficients"][key]) > 1e-4:
                    fails.append(f"{key} {c[key]} vs {g['coefficients'][key]}")
        else:
            if res.mode != "viscous" or "warning" in c:
                fails.append(f"mode {res.mode}, coefficients {c}")
            fails += _coefficients_held(c, g["ensemble"])
            if not (res.bl_data and _bl_schema(res.bl_data,
                                               NEWTON_SHAPE["n_stations"])):
                fails.append("bl_data schema")
        if len(res.cp_x) != len(res.cp_values) != N_PANELS:
            fails.append("cp length")
        log(f"[analyze] NACA 2412 ({g['coords']} points a side) alpha "
            f"{g['alpha']:g} Re {g['re']:g}: mode {res.mode}, strategy "
            f"{res.strategy}, {c}; golden {g['coefficients']} (strategy "
            f"{g['strategy']}); solver calls {calls}, the reference's "
            f"{g['calls']}; {walls[g['alpha']]:.3f} s "
            f"{'ok' if not fails else 'FAIL ' + str(fails)}")
        require(not fails, f"analyze alpha {g['alpha']}: {fails}")
    return walls


def phase_upload(goldens, make_server, run_log_dir, stats, analyze_mod):
    """``POST /upload_airfoil/`` on the port's server on the card with
    golden (e)'s file; returns the request's wall seconds."""
    g = goldens["upload"]
    want = g["reply"]
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    count0 = stats.get_analysis_count()
    try:
        with recorded_solvers(analyze_mod) as calls:
            t0 = time.perf_counter()
            status, body = _post(url + "/upload_airfoil/",
                                 {"reynolds": g["reynolds"],
                                  "alpha": g["alpha"]},
                                 {"file": (g["filename"], g["dat"].encode())})
            wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    fails = []
    if status != 200 or set(body) != set(want):
        fails.append(f"status {status}, keys {sorted(body)}")
    else:
        c = body["coefficients"]
        fails += _coefficients_held(c, g["ensemble"])
        for key in ("coords_before", "coords_after", "num_points",
                    "parser_fixes"):
            if body[key] != want[key]:
                fails.append(f"{key} differs from the reference's")
        if not np.allclose(body["cp_x"], want["cp_x"], rtol=1e-5, atol=1e-6):
            fails.append("cp_x")
        if c["mode"] == "viscous" and not _bl_schema(
                body["bl_data"], NEWTON_SHAPE["n_stations"]):
            fails.append("bl_data schema")
    logs = os.listdir(run_log_dir)
    count = stats.get_analysis_count()
    if len(logs) != 1 or count != (count0 or 0) + 1:
        fails.append(f"{len(logs)} run logs, analysis count {count0} -> "
                     f"{count}")
    log(f"[upload] POST /upload_airfoil/ ({g['filename']}, Re "
        f"{g['reynolds']:g}, alpha {g['alpha']:g}) on the card: {status}, "
        f"{body.get('coefficients')}; golden {want['coefficients']}, "
        f"ensemble {g['ensemble']}; solver calls {calls}, the reference's "
        f"{g['calls']}; {len(logs)} run log, analysis count "
        f"{count}; {wall:.3f} s (HTTP round trip) "
        f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"upload: {fails}")
    return wall


POLAR_GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_polar.json")
# The sweep's per-point and continuation solves: warm passes, LM
# iterations a round; side marches a solve are warm passes + 2.
POINTS_SHAPE = {"warm_iters": 8, "newton_iters": 10}
CONT_SHAPE = {"warm_iters": 1, "newton_iters": 14}


def precise_dat(name: str, coords) -> str:
    """A .dat file whose coordinates parse back to the same float32
    values (9 significant digits)."""
    return name + "\n" + "\n".join(f" {x:.9g} {y:.9g}"
                                   for x, y in np.asarray(coords, np.float32))


def nearest_member(rec: dict, members, bars=None) -> tuple[float, int]:
    """(distance, index) of the member of ``members`` ((index, member)
    pairs) nearest ``rec`` jointly: a member's distance is the largest,
    over the barred fields, of |rec - member| in units of the field's bar
    around the member (at most 1: every field within its bar)."""
    bars = VISCOUS_BARS if bars is None else bars
    return min((max(abs(rec[f] - m[f]) / (a + r * abs(m[f]))
                    for f, (a, r) in bars.items()), i) for i, m in members)


def held_to_polar(rec: dict, golden: dict) -> tuple[list, str]:
    """A polar point or batch lane ``rec`` held jointly to one member of
    the reference's rounding ensemble. Its candidates are the members that
    share its verdict (``mode`` where it has one, and ``converged``); it
    is held when every barred field lies within its bar of one candidate.
    Where none holds it, rounding has moved the port's transition by a
    station or so off every member's, which moves CD most: it then passes
    only if every barred field but CD lies within its bar of one
    candidate (the reference's basin: its transitions, lift and moment),
    and the note names those candidates beside the nearest member. The
    lane's arithmetic, CD included, is held apart from its basin by the
    solve from the reference's own states (``held_from_states``). Returns
    (failures, note)."""
    flags = [f for f in ("mode", "converged") if f in rec]
    cands = [(i, m) for i, m in enumerate(golden["members"])
             if all(m[f] == rec[f] for f in flags)]
    if not cands:
        return [f"{ {f: rec[f] for f in flags} } not among the verdicts of "
                f"the ensemble's members"], ""
    d, i = nearest_member(rec, cands)
    note = f"nearest member {i} at {d:.3f} bars"
    if d <= 1.0:
        return [], note
    but_cd = {f: b for f, b in VISCOUS_BARS.items() if f != "cd"}
    basin = [j for j, m in cands
             if nearest_member(rec, [(j, m)], but_cd)[0] <= 1.0]
    if not basin:
        return [f"off every member jointly ({note}) and in no member's "
                f"basin"], note
    return [], (f"off every member jointly ({note}): a knife edge, all "
                f"but CD within the bars of members {basin}")


# The bars of a lane's answer at the reference's own final state: the
# same arithmetic on the same state, up to the card's rounding.
STATE_BARS = {"cl": (1e-4, 0.0), "cd": (0.0, 1e-4), "cm": (1e-4, 0.0),
              "xtr_upper": (1e-4, 0.0), "xtr_lower": (1e-4, 0.0)}


def held_from_states(newton, op, recs, reynolds, dev, label: str) -> float:
    """The lane-batched system at the reference's own final states
    (``points_pass``: its per-point pass of a polar, or its batch) in place
    of the LM rounds' result: set up as the solve sets it up (warm start,
    trip ceilings), each lane's residual, answer and verdicts are taken at
    the reference's state, so no basin is chosen. Every lane must give the
    reference's verdicts; every lane the reference solved, its answer
    within ``STATE_BARS``. (A lane whose Newton solve failed answers with
    the warm-start fallback, which the state does not reach: its verdicts
    hold it.) ``op`` is one operator or one a lane. Returns the largest
    distance, in units of ``STATE_BARS``."""
    zz, xu, xl = newton.state_from_numpy(
        [r["state"]["zz"] for r in recs], [r["state"]["xtr_u"] for r in recs],
        [r["state"]["xtr_l"] for r in recs], device=dev)
    alphas = torch.tensor([r["alpha"] for r in recs], device=dev)
    t0 = time.perf_counter()
    system, sc, warm_state, zz = newton._prepare(
        op, alphas, reynolds, 9.0, 1.0, 96, 20, POINTS_SHAPE["warm_iters"],
        init_state=(zz, xu, xl))
    rms = newton._rms(system.residual(zz))
    merged, (nok, _state) = newton._points_out(*newton._lane_answer(
        system, sc, warm_state, zz, rms))
    secs = time.perf_counter() - t0
    worst, fails = 0.0, []
    for i, want in enumerate(recs):
        rec = merged_record(([v[i] for v in merged], (nok[i], None)))
        flags = ("converged", "newton_converged")
        if any(rec[f] != want[f] for f in flags):
            fails.append(f"lane {i}: verdicts {[rec[f] for f in flags]}, "
                         f"the reference's {[want[f] for f in flags]}")
        elif want["newton_converged"]:
            d, _ = nearest_member(rec, [(0, want)], STATE_BARS)
            worst = max(worst, d)
            if d > 1.0:
                fails.append(f"lane {i} (alpha {want['alpha']:g}): "
                             f"{json.dumps(rec)} is {d:.3f} bars off the "
                             f"reference's {json.dumps({f: want[f] for f in STATE_BARS})}")
    log(f"[polar states] {label}: every lane's answer at the reference's "
        f"final state ({secs:.3f} s, residual rms "
        f"{[round(float(r), 6) for r in rms]}): the "
        f"{sum(r['newton_converged'] for r in recs)} lanes the reference "
        f"solved at most {worst:.4f} of their bars (CL, Cm, x_tr 1e-4; CD "
        f"1e-4 relative) {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"{label}: {fails}")
    return worst


def polar_record(res, i: int) -> dict:
    return {"alpha": float(res.alpha[i]), "cl": float(res.cl[i]),
            "cd": float(res.cd[i]), "cdp": float(res.cdp[i]),
            "cm": float(res.cm[i]), "mode": int(res.mode[i]),
            "converged": bool(res.converged[i]),
            "xtr_upper": float(res.xtr_upper[i]),
            "xtr_lower": float(res.xtr_lower[i]),
            "sep_fraction": float(res.sep_fraction[i])}


@contextlib.contextmanager
def lm_rounds_recorded(newton):
    """Records (lanes, rounds each lane ran) of every LM round loop."""
    runs = []
    orig = newton._lm_rounds

    def counted(system, *args):
        out = orig(system, *args)
        runs.append((system.lanes[0], out[2].tolist()))
        return out

    newton._lm_rounds = counted
    try:
        yield runs
    finally:
        newton._lm_rounds = orig


def _lane_counts(calls) -> dict:
    out = {}
    for c in calls:
        n = c[0].reshape(-1, c[0].shape[-1]).shape[0]
        out[n] = out.get(n, 0) + 1
    return out


def phase_polar(dev, card, pgold, sweep, newton, mk, plain):
    """The main path of this slice: ``solve_polar`` of the golden polar on
    the card, every point held to the reference's ensemble; the sweep's
    marches (launches, lanes) and walk solves counted, the per-point pass's
    marches held to the plain march, its profile, and the march kernels
    at the polar path's 64 and 128 lanes. Returns (the result, {kernel:
    its launches}, {kernel: its lanes a launch}, timings)."""
    g = pgold["polar"]
    coords = np.asarray(naca4_coords(*g["naca"]), np.float32)
    mk.march_launches = 0
    mk.wake_launches = 0
    sweep.walk_solves.update(cont=0, trip=0)
    with lm_rounds_recorded(newton) as runs, recording(mk) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.solve_polar(coords, g["alphas"], g["re"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"bl_march": mk.march_launches,
                "bl_march_wake": mk.wake_launches}
    walk = dict(sweep.walk_solves)
    n_walk = walk["cont"] + walk["trip"]
    p = sweep._bucket_size(len(g["alphas"]))
    sides = _lane_counts(calls["march_side"])
    wakes = _lane_counts(calls["march_wake"])
    per_pass = POINTS_SHAPE["warm_iters"] + 2
    per_cont = CONT_SHAPE["warm_iters"] + 2
    passes = wakes.get(p, 0)       # the per-point pass and the rescue
    require(passes in (1, 2) and sides.get(2 * p, 0) == per_pass * passes
            and sides.get(2, 0) == per_cont * n_walk
            and wakes.get(1, 0) == n_walk
            and sum(sides.values()) == launches["bl_march"]
            and sum(wakes.values()) == launches["bl_march_wake"],
            f"polar marches: side lanes {sides}, wake lanes {wakes}, "
            f"launches {launches}, walk solves {walk}")
    fails = []
    for i, pg in enumerate(g["points"]):
        rec = polar_record(res, i)
        f, note = held_to_polar(rec, pg)
        fails += [f"alpha {pg['alpha']:g}: {x}" for x in f]
        log(f"[polar] alpha {pg['alpha']:g}: {json.dumps(rec)}; golden mode "
            f"{pg['mode']} cl {pg['cl']:.4f} cd {pg['cd']:.5f}; ensemble "
            f"{json.dumps(pg['ensemble'])}; {note} "
            f"{'ok' if not f else 'FAIL'}")
    points_lanes, points_rounds = runs[0]
    lm_iters = max(points_rounds) * POINTS_SHAPE["newton_iters"]
    log(f"[polar] solve_polar NACA {''.join(map(str, g['naca'][:3]))} "
        f"({g['naca'][3]} points a side), alpha {g['alphas']} at Re "
        f"{g['re']:g}: {len(g['alphas'])} points in a bucket of {p} lanes, "
        f"{wall:.3f} s wall ({card}); per-point pass: {points_lanes} lanes, "
        f"rounds a lane {points_rounds}, {lm_iters} LM iterations; walk: "
        f"{walk['cont']} continuation and {walk['trip']} trip solves "
        f"(rounds {[r for _, r in runs[1:1 + n_walk]]}); rescue pass "
        f"{'run' if passes == 2 else 'not needed'}; march launches "
        f"{launches} (side lanes a launch: {sides}; wake: {wakes}); modes "
        f"{res.mode.tolist()} {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"polar: {fails}")
    worst, _batch = hold_recorded_marches(
        dev, mk, plain, calls["march_side"][:per_pass],
        calls["march_wake"][:1], 0, 0,
        f"the polar's per-point pass ({p} lanes)", stage="polar march",
        xtr_between=True)

    # The per-point pass alone: wall, and device time from the profiler.
    op, _xp, _yp = sweep._op_kernel(sweep._pad_coords(
        torch.as_tensor(coords, device=dev)), N_PANELS)
    a_np = np.asarray(g["alphas"], np.float32)
    a_in = torch.as_tensor(np.concatenate(
        [a_np, np.repeat(a_np[-1:], p - len(a_np))]), device=dev)
    re_in = torch.full((p,), g["re"], dtype=torch.float32, device=dev)
    t_pass = _median_s(lambda: sweep._points_kernel(op, a_in, re_in), 2)
    with traced() as prof:
        sweep._points_kernel(op, a_in, re_in)
    ev = kernel_events(prof, "march_side_kernel", "march_wake_kernel")
    busy = ev["all"][1] / 1e3 / (t_pass * 1e3)
    log(f"[polar] the per-point pass alone ({p} lanes): {t_pass:.3f} s wall "
        f"(median of 2), profiled: {ev['all'][0]} device kernels, "
        f"{ev['all'][1] / 1e3:.3f} ms of device time (march_side_kernel "
        f"{ev['march_side_kernel'][0]} x, "
        f"{ev['march_side_kernel'][1] / 1e3:.3f} ms; march_wake_kernel "
        f"{ev['march_wake_kernel'][0]} x, "
        f"{ev['march_wake_kernel'][1] / 1e3:.3f} ms): device busy "
        f"{busy:.1%} of the wall ({card})")
    held_from_states(newton, op, g["points_pass"], g["re"], dev,
                     f"the polar's per-point pass ({p} lanes)")

    # One LM iteration as the lane count grows: its host issue stays one
    # solve's, its device time grows with the lanes.
    for lanes in (1, p, 64):
        alphas = np.linspace(-2.0, 6.0, lanes).tolist()
        system, zz, lam = newton_system(dev, newton, op, alphas)
        system.lm_step(zz, lam)
        lm_wall = _median_s(lambda: system.lm_step(zz, lam), 3)
        with traced() as prof:
            system.lm_step(zz, lam)
        ev_lm = kernel_events(prof)["all"]
        log(f"[polar] one LM iteration of {lanes} lane(s): {lm_wall * 1e3:.3f}"
            f" ms wall (median of 3, synchronised), {ev_lm[0]} device "
            f"kernels, {ev_lm[1] / 1e3:.3f} ms of device time "
            f"({ev_lm[1] / 1e3 / (lm_wall * 1e3):.1%} busy) ({card})")
        del system, zz, lam

    # The march kernels at the polar path's lane counts: 2P side lanes of
    # the 31-point (bucket 32) and 43-point (bucket 64) polars, P wakes.
    side0, wake0 = calls["march_side"][0], calls["march_wake"][0]
    at_lanes = {}
    for lanes in (64, 128):
        s_args = _stack_calls([side0] * (lanes // (2 * p)), 3)
        w_args = _stack_calls([wake0] * (lanes // p), 2)
        at_lanes[lanes] = {
            "bl_march": (cuda_ms(lambda: mk.march_side(*s_args), 20),
                         side_march_bound(mk, plain, s_args)[0]),
            "bl_march_wake": (cuda_ms(lambda: mk.march_wake(*w_args), 20),
                              wake_march_bound(mk, plain, w_args)[0])}
        log(f"[polar] march kernels at {lanes} lanes: side ({lanes} x "
            f"{side0[0].shape[-1]} stations) "
            f"{at_lanes[lanes]['bl_march'][0]:.4f} ms (CUDA events, mean of "
            f"20), bound {at_lanes[lanes]['bl_march'][1][0] * 1e3:.3f} us; "
            f"wake ({lanes} x {wake0[0].shape[-1]} stations) "
            f"{at_lanes[lanes]['bl_march_wake'][0]:.4f} ms, bound "
            f"{at_lanes[lanes]['bl_march_wake'][1][0] * 1e3:.3f} us ({card})")
    lanes_of = {"bl_march": sorted(sides), "bl_march_wake": sorted(wakes)}
    return res, launches, lanes_of, worst, at_lanes


def phase_batch(dev, pgold, polar, newton, mk):
    """``solve_batch`` of the golden pair on the card (one lane a file),
    each lane held to the reference's ensemble, then its lanes solved from
    the reference's own states; returns the result."""
    g = pgold["batch"]
    mk.march_launches = 0
    mk.wake_launches = 0
    coords = [np.asarray(naca4_coords(*spec), np.float32)
              for spec in g["files"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = polar.solve_batch(coords, g["re"], g["alpha"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = ("cl", "cd", "cdp", "cm", "converged", "xtr_upper", "xtr_lower",
             "sep_fraction")
    fails = []
    for i, lg in enumerate(g["lanes"]):
        rec = {f: (bool(getattr(res, f)[i]) if f == "converged"
                   else float(getattr(res, f)[i])) for f in names}
        f, note = held_to_polar(rec, lg)
        fails += [f"lane {i}: {x}" for x in f]
        log(f"[batch] lane {i} NACA {g['files'][i][:3]}: {json.dumps(rec)}; "
            f"golden cl {lg['cl']:.4f} cd {lg['cd']:.5f} converged "
            f"{lg['converged']}; ensemble {json.dumps(lg['ensemble'])}; "
            f"{note} {'ok' if not f else 'FAIL'}")
    per_pass = POINTS_SHAPE["warm_iters"] + 2
    if (mk.march_launches, mk.wake_launches) != (per_pass, 1):
        fails.append(f"{mk.march_launches} side and {mk.wake_launches} wake "
                     f"launches, want {per_pass} and 1")
    log(f"[batch] solve_batch of {len(coords)} files at alpha {g['alpha']:g},"
        f" Re {g['re']:g}: {wall:.3f} s wall, {mk.march_launches} side "
        f"launches of {2 * len(coords)} lanes, {mk.wake_launches} wake "
        f"launch of {len(coords)} "
        f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"batch: {fails}")
    held_from_states(newton, polar.batch._batch_ops(coords, N_PANELS, dev),
                     g["points_pass"], g["re"], dev,
                     f"the batch ({len(coords)} lanes)")
    return res


def phase_served(pgold, make_server, parse_upload, stats, polar_res,
                 batch_res):
    """``POST /polar/`` (the golden sweep) and ``POST /batch/`` (the golden
    pair) on the port's server on the card, each equal to the library's
    answer to the JSON's rounding, then ``GET /stats``: the counter grows
    by the analyses served. Returns the requests' wall seconds."""
    g, gb = pgold["polar"], pgold["batch"]
    dat = precise_dat("NACA", naca4_coords(*g["naca"])).encode()
    parsed, fixes = parse_upload("polar.dat", dat)
    require(np.array_equal(np.asarray(parsed, np.float32), np.asarray(
        naca4_coords(*g["naca"]), np.float32)),
        f"the served .dat does not parse back to the library's loop "
        f"(parser fixes {fixes})")
    files = [("files", (f"naca{i}.dat",
                        precise_dat("NACA", naca4_coords(*spec)).encode()))
             for i, spec in enumerate(gb["files"])]
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    a = g["alphas"]
    try:
        count0 = stats.get_analysis_count() or 0
        t0 = time.perf_counter()
        status, body = _post(url + "/polar/", {
            "reynolds": g["re"], "alpha_start": a[0], "alpha_end": a[-1],
            "alpha_step": a[1] - a[0]}, {"file": ("polar.dat", dat)})
        t_polar = time.perf_counter() - t0
        t0 = time.perf_counter()
        b_status, b_body = _post(url + "/batch/", {
            "reynolds": gb["re"], "alpha": gb["alpha"]}, files)
        t_batch = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            s_status, s_body = r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    fails = []
    names = {0: "viscous", 1: "viscous_smoothed", 2: "inviscid"}
    if status != 200 or len(body.get("polar", [])) != len(a):
        fails.append(f"/polar/ {status} {str(body)[:200]}")
    else:
        for i, row in enumerate(body["polar"]):
            want = {"alpha": float(polar_res.alpha[i]),
                    "CL": round(float(polar_res.cl[i]), 4),
                    "CD": round(float(polar_res.cd[i]), 6),
                    "CDp": round(float(polar_res.cdp[i]), 6),
                    "Cm": round(float(polar_res.cm[i]), 4),
                    "mode": names[int(polar_res.mode[i])],
                    "converged": bool(polar_res.converged[i]),
                    "xtr_upper": round(float(polar_res.xtr_upper[i]), 4),
                    "xtr_lower": round(float(polar_res.xtr_lower[i]), 4),
                    "sep_fraction": round(float(polar_res.sep_fraction[i]),
                                          4)}
            if row != want:
                fails.append(f"/polar/ row {i} {row} != library {want}")
    rows = b_body.get("results", []) if b_status == 200 else []
    if len(rows) != len(gb["files"]):
        fails.append(f"/batch/ {b_status} {str(b_body)[:200]}")
    for i, row in enumerate(rows):
        for key, f, nd in (("CL", "cl", 4), ("CD", "cd", 6), ("CDp", "cdp", 6),
                           ("Cm", "cm", 4), ("xtr_upper", "xtr_upper", 4),
                           ("xtr_lower", "xtr_lower", 4)):
            if row.get(key) != round(float(getattr(batch_res, f)[i]), nd):
                fails.append(f"/batch/ row {i} {key} {row.get(key)}")
        if row.get("converged") != bool(batch_res.converged[i]):
            fails.append(f"/batch/ row {i} converged")
    served = 1 + len(gb["files"])
    if s_status != 200 or s_body.get("total_analyses") != count0 + served:
        fails.append(f"/stats {s_status} {s_body}, want {count0 + served}")
    log(f"[served] POST /polar/ ({len(a)} points) {status} in {t_polar:.3f} s"
        f", equal to the library's polar to the JSON's rounding; POST "
        f"/batch/ ({len(files)} files) {b_status} in {t_batch:.3f} s: "
        f"{rows}; GET /stats {s_status} {s_body} (was {count0}) "
        f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"served: {fails}")
    return {"polar": t_polar, "batch": t_batch}


def phase_newton_speed(card, dev, newton, op, mk, plain, side_call,
                       wake_call):
    """The Newton solve's profile at the speed point: wall time, rounds and
    LM iterations, host synchronisations, device time and busy share; one
    LM iteration's launches and device time, the batched Cholesky solves,
    ``_reproject_n``'s station loop; the march kernels at the solve's
    shapes. Returns ({kernel: (ms, plain ms, device ms)}, {kernel: (bound
    ms, what bounds it)}) at those shapes."""
    code, alpha, re = NEWTON_POINT
    # The kernels first: late in a long process the profiler has dropped
    # every record of a short window that followed the long traces below.
    k_ms = cuda_ms(lambda: mk.march_side(*side_call), 50)
    k_dev = device_ms(lambda: mk.march_side(*side_call), 20,
                      "march_side_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_side(*side_call)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    w_ms = cuda_ms(lambda: mk.march_wake(*wake_call), 50)
    w_dev = device_ms(lambda: mk.march_wake(*wake_call), 20,
                      "march_wake_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_wake(*wake_call)
    torch.cuda.synchronize()
    w_plain_ms = (time.perf_counter() - t0) * 1e3
    side_bound, side_ops = side_march_bound(mk, plain, side_call)
    wake_bound, wake_ops = wake_march_bound(mk, plain, wake_call)
    m, mw = side_call[0].shape[-1], wake_call[0].shape[-1]
    log(f"[newton speed] the Newton solve's marches: side pair, 2 lanes x "
        f"{m} stations: kernel {k_ms:.4f} ms (CUDA events, mean of 50; "
        f"device {k_dev:.4f} ms), plain {plain_ms:.1f} ms (one call, host "
        f"clock), bound {side_bound[0] * 1e3:.3f} us ({side_ops:.4g} "
        f"operations, set by {side_bound[1]}); wake, 1 lane x {mw} stations: "
        f"kernel {w_ms:.4f} ms (device {w_dev:.4f} ms), plain "
        f"{w_plain_ms:.1f} ms, bound {wake_bound[0] * 1e3:.3f} us "
        f"({wake_ops:.4g} operations, set by {wake_bound[1]}) ({card})")

    def solve():
        return newton.solve_viscous_newton(op, alpha, re)

    solve()                                     # warm
    n_lm = [0]
    lm_step = newton._System.lm_step

    def counted(self, zz, lam):
        n_lm[0] += 1
        return lm_step(self, zz, lam)

    newton._System.lm_step = counted
    try:
        r = solve()
        torch.cuda.synchronize()
    finally:
        newton._System.lm_step = lm_step
    iters = NEWTON_SHAPE["newton_iters"]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    t_solve = _median_s(solve, 10)
    with traced() as prof:
        solve()
    ev = kernel_events(prof, "march_side_kernel", "march_wake_kernel")
    log(f"[newton speed] NACA {code} alpha {alpha:g} Re {re:g}, default "
        f"solve_viscous_newton ({N_PANELS} panels, {json.dumps(NEWTON_SHAPE)}"
        f", <= 4 rounds): median of 10, synchronised, {t_solve * 1e3:.3f} ms; "
        f"{n_lm[0]} LM iterations ({n_lm[0] / iters:g} rounds), converged "
        f"{bool(r.converged)}; {syncs} host synchronisations in a solve; "
        f"profiled solve: {ev['all'][0]} device kernels, "
        f"{ev['all'][1] / 1e3:.3f} ms of device time (march_side_kernel "
        f"{ev['march_side_kernel'][0]} x, {ev['march_side_kernel'][1] / 1e3:.3f}"
        f" ms; march_wake_kernel {ev['march_wake_kernel'][0]} x, "
        f"{ev['march_wake_kernel'][1] / 1e3:.3f} ms); device busy "
        f"{ev['all'][1] / 1e3 / (t_solve * 1e3):.1%} of the median wall "
        f"({card})")

    system, zz, lam = newton_system(dev, newton, op)
    system.lm_step(zz, lam)
    rms, jtj, jtr = system.normal_equations(zz)
    ops = {"LM iteration": count_dispatches(system.lm_step, zz, lam),
           "residual": count_dispatches(system.residual, zz),
           "coloured Jacobian": count_dispatches(system.jacobian, zz),
           "candidate steps": count_dispatches(system.candidate_steps, jtj,
                                               jtr, lam),
           "_reproject_n": count_dispatches(system.reproject_n, zz)}
    log(f"[newton speed] torch operations dispatched: "
        + ", ".join(f"{k} {v}" for k, v in ops.items()))
    lm_wall = _median_s(lambda: system.lm_step(zz, lam), 10)
    with traced() as prof:
        system.lm_step(zz, lam)
    ev_lm = kernel_events(prof)["all"]
    chol_ms = cuda_ms(lambda: system.candidate_steps(jtj, jtr, lam), 20)
    with traced() as prof:
        system.candidate_steps(jtj, jtr, lam)
    ev_chol = kernel_events(prof)["all"]
    ne_wall = _median_s(lambda: system.normal_equations(zz), 10)
    rep_wall = _median_s(lambda: system.reproject_n(zz), 10)
    with traced() as prof:
        system.reproject_n(zz)
    ev_rep = kernel_events(prof)["all"]
    log(f"[newton speed] one LM iteration: {lm_wall * 1e3:.3f} ms wall "
        f"(median of 10, synchronised), {ev_lm[0]} device kernels, "
        f"{ev_lm[1] / 1e3:.3f} ms of device time "
        f"({ev_lm[1] / 1e3 / (lm_wall * 1e3):.1%} busy); of it the "
        f"residual, the coloured Jacobian, J^T J and J^T r "
        f"{ne_wall * 1e3:.3f} ms wall; the four damped "
        f"{zz.shape[-1]}^2 Cholesky "
        f"solves (batched cholesky_ex, two triangular solves, clip) "
        f"{chol_ms:.4f} ms (CUDA events, mean of 20), {ev_chol[0]} device "
        f"kernels, {ev_chol[1] / 1e3:.4f} ms of device time; "
        f"_reproject_n (a {NEWTON_SHAPE['n_stations'] - 1}-station loop of "
        f"two lanes) "
        f"{rep_wall * 1e3:.3f} ms wall, {ev_rep[0]} device kernels, "
        f"{ev_rep[1] / 1e3:.3f} ms of device time ({card})")

    return ({"bl_march": (k_ms, plain_ms, k_dev),
             "bl_march_wake": (w_ms, w_plain_ms, w_dev)},
            {"bl_march": side_bound, "bl_march_wake": wake_bound})


def phase_mask_speed(dev, card, masks, cfg_cls, WindTunnel):
    """Host time of the solid mask that ``/lbm/start`` builds at the served
    384x192 and of a 2048x1024 ``WindTunnel``'s construction, mask
    included."""
    coords = naca4_coords()
    t_served = _median_s(lambda: masks.build_mask(coords, 6.0, cfg_cls()), 20)
    big = cfg_cls(nx=LARGE[0], ny=LARGE[1])
    t_big = _median_s(lambda: masks.rasterize_airfoil(coords, 6.0, big), 5)
    t_tunnel = _median_s(lambda: WindTunnel(coords, cfg=big, device=dev), 3)
    log(f"[speed] solid mask (numpy scanline, median): 384x192 "
        f"{t_served * 1e3:.3f} ms, {LARGE[0]}x{LARGE[1]} {t_big * 1e3:.3f} ms; "
        f"WindTunnel construction at {LARGE[0]}x{LARGE[1]} "
        f"{t_tunnel * 1e3:.3f} ms ({card})")


def lbm_bound(dev, core, masks, cfg_cls, grid) -> tuple[float, str]:
    """Bound of one ``steps_per_frame``-step LBM call on ``grid``: the
    lattice read and written once and the cell word, which is what the
    kernels read of the mask, read once; the operations of the plain
    step."""
    cfg = cfg_cls(nx=grid[0], ny=grid[1])
    solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                         device=dev)
    f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
    ops = count_ops(core.lbm_step, f, solid, cfg.u0, cfg.tau,
                    steps=cfg.steps_per_frame)
    return bound(2 * nbytes(f) + nbytes(core.cell_word(solid)), ops)


def word_bound(dev, core, masks, cfg_cls) -> tuple[float, str]:
    """Bound of one cell word at the served grid: the mask read once and the
    word written once; the operations of the plain word."""
    solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0,
                                                 cfg_cls()), device=dev)
    return bound(nbytes(solid, core.cell_word(solid)),
                 count_ops(core.cell_word, solid))


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
    # The upload phase's run log and analysis counter go to a scratch
    # directory of this run (the counter's path is read at import).
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    run_log_dir = os.path.join(work, "runs")
    os.environ["AIRFOIL_TPU_RUN_LOG_DIR"] = run_log_dir
    os.environ["AIRFOIL_TPU_STATS_PATH"] = os.path.join(work, "stats.db")
    try:
        return run(run_log_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(run_log_dir: str) -> int:
    from airfoil_tpu_torch import cuda_build
    from airfoil_tpu_torch.config import LBMConfig
    from airfoil_tpu_torch.api.handlers import parse_upload
    from airfoil_tpu_torch.api.minihttp import make_server
    from airfoil_tpu_torch.device import resolve_device
    from airfoil_tpu_torch.lbm import core, diagnostics, kernel, masks
    from airfoil_tpu_torch.lbm.bench import bench_mlups
    from airfoil_tpu_torch.lbm.runner import WindTunnel
    from airfoil_tpu_torch import inviscid, paneling, polar
    from airfoil_tpu_torch.polar import analyze as analyze_mod
    from airfoil_tpu_torch.utils import stats
    from airfoil_tpu_torch.viscous import coupled, march, newton, wake
    from airfoil_tpu_torch.viscous import kernel as march_kernel

    dev = resolve_device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    k = phase_build(cuda_build, kernel, march_kernel)
    max_abs = dict(zip(("lbm_steps", "cell_word"),
                       phase_kernel(dev, kernel, core, masks, LBMConfig)))
    launches, _ = phase_server(kernel, make_server, parse_upload,
                               masks.build_mask, LBMConfig().steps_per_frame)
    max_abs["lbm_steps_tiled"] = phase_tiled(dev, kernel, core, masks,
                                             LBMConfig, k)
    phase_physics(dev, WindTunnel)
    launches["lbm_steps_tiled"] = phase_large(dev, kernel, WindTunnel,
                                              LBMConfig)
    times = phase_speed(dev, card, kernel, core, diagnostics, masks,
                        LBMConfig, bench_mlups)
    phase_mask_speed(dev, card, masks, LBMConfig, WindTunnel)
    bounds = {"lbm_steps": lbm_bound(dev, core, masks, LBMConfig, (384, 192)),
              "cell_word": word_bound(dev, core, masks, LBMConfig),
              "lbm_steps_tiled": lbm_bound(dev, core, masks, LBMConfig, LARGE)}

    goldens = load_goldens()
    ops = {code: naca_operator(code, dev, paneling, inviscid)
           for code in ("0012", "2412", "4412")}
    phase_inviscid(goldens, ops, inviscid)
    march_abs, sides, batch = phase_march(dev, march_kernel, march, coupled,
                                          inviscid, ops["2412"],
                                          goldens["trip_x"])
    max_abs.update(march_abs)
    results, march_launches = phase_viscous(goldens, ops, coupled,
                                            march_kernel)
    launches.update(march_launches)
    phase_viscous_anchors(results, ops, coupled, inviscid, march_kernel)
    march_times, march_bounds = phase_viscous_speed(
        card, ops, inviscid, coupled, wake, march_kernel, march, sides, batch)
    times.update(march_times)
    bounds.update(march_bounds)

    # The simultaneous-Newton path: the solver, analyze_airfoil and the
    # served upload.
    ngold = load_goldens(NEWTON_GOLDENS)
    op = ops["2412"]
    newton_abs, side_call, wake_call = phase_newton_march(
        dev, march_kernel, march, newton, op, goldens["trip_x"])
    newton_launches = phase_newton(dev, ngold, ops, newton, march_kernel)
    phase_lm_sync_free(dev, newton, op)
    walls = phase_analyze(dev, ngold, polar, analyze_mod)
    walls["upload"] = phase_upload(ngold, make_server, run_log_dir, stats,
                                   analyze_mod)
    # The polar and batch path: the sweep, the batch, the served routes.
    from airfoil_tpu_torch.polar import sweep
    pgold = load_goldens(POLAR_GOLDENS)
    polar_res, polar_launches, polar_lanes, polar_abs, at_lanes = \
        phase_polar(dev, card, pgold, sweep, newton, march_kernel, march)
    batch_res = phase_batch(dev, pgold, polar, newton, march_kernel)
    walls.update(phase_served(pgold, make_server, parse_upload, stats,
                              polar_res, batch_res))
    newton_times, newton_bounds = phase_newton_speed(
        card, dev, newton, op, march_kernel, march, side_call, wake_call)
    log(f"[newton speed] wall: analyze_airfoil alpha 4 {walls[4.0]:.3f} s, "
        f"alpha 19 {walls[19.0]:.3f} s; POST /upload_airfoil/ alpha 5 "
        f"{walls['upload']:.3f} s; POST /polar/ {walls['polar']:.3f} s; "
        f"POST /batch/ {walls['batch']:.3f} s ({card})")
    newton_keys = {name: {
        "newton_launches": newton_launches[name],
        "newton_max_abs_err": newton_abs[name],
        "newton_ms": newton_times[name][0],
        "newton_device_ms": newton_times[name][2],
        "newton_plain_ms": newton_times[name][1],
        "newton_bound_ms": newton_bounds[name][0],
        "newton_bound_by": newton_bounds[name][1]} for name in newton_abs}
    for name, err in newton_abs.items():
        max_abs[name] = max(max_abs[name], err, polar_abs[name])
    for name in newton_keys:
        newton_keys[name].update({
            "polar_launches": polar_launches[name],
            "polar_lanes": polar_lanes[name],
            "polar_max_abs_err": polar_abs[name],
            **{f"polar_{key}_{lanes}_lanes": v for lanes in (64, 128)
               for key, v in (("ms", at_lanes[lanes][name][0]),
                              ("bound_ms", at_lanes[lanes][name][1][0]))}})

    refused = [m for m in sys.modules
               if m.partition(".")[0] in ("jax", "airfoil_tpu")]
    require(not refused, f"the reference or jax was imported: {refused[:5]}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_abs[name],
        "ms": times[name][0], "device_ms": times[name][2],
        "plain_ms": times[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": None, **newton_keys.get(name, {})}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
