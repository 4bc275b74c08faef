"""Headline benchmark of the port: viscous polar throughput and LBM MLUPS.

The counterpart of the repository's ``bench.py``, with the same polar, the
same mode accounting and the same baselines, as two JSON lines:

  line 1: {"metric": "viscous_polar_points_per_sec", ...}
  line 2: {"metric": "lbm_mlups", ...}

Line 1 is printed and flushed before the LBM runs, so a failure there
cannot lose it. Errors are not caught: a failing stage ends the run with a
non-zero exit and a traceback, after whatever lines were already printed.

The polar is NACA 2412 (100 points a side), alpha -10..20 step 1, Re 1e6,
through the served ``polar.sweep.solve_polar``: ``warm_polar_kernels`` of
the 32-point bucket (the march kernel's build and the Newton solve's
graph captures), one warm-up call, then ``reps`` timed calls with alpha
perturbed by 0.001 a repetition, as ``bench.py`` does. The LBM throughput is
``lbm.bench.bench_mlups`` at 640x384 (the resident ``lbm_steps``), the
served 384x192 and 2048x1024 (past the resident kernel's capacity:
``lbm_steps_tiled``); each grid records which kernel ran and the launches
it made (the counters of ``lbm/kernel.py``). Every record names the
platform, the device and, on a card, its name and power limit from
``nvidia-smi``.

Baselines (not TPU figures): the reference service computes each polar
point as one XFOIL subprocess round trip, quoted at 30-60 s, so 1/30
points/s; its browser tunnel runs ~12.3 MLUPS.

The device is ``cuda`` unless ``--device cpu`` is given; nothing falls back
to the CPU. On the CPU the run is ``bench.py``'s reduced configuration:
11 points from -4 to 5, 1 repetition, LBM at 256x128 with 16 steps a call
and 2 calls.

CLI: python3 -m airfoil_tpu_torch.bench.headline [--device D] [--reps R]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from airfoil_tpu_torch.bench.parity import card as card_name
from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.lbm import kernel as lbm_kernel
from airfoil_tpu_torch.lbm.bench import bench_mlups
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.polar import sweep
from airfoil_tpu_torch.viscous import graphs
from airfoil_tpu_torch.viscous import kernel as march_kernel

__all__ = ["bench_polar", "bench_lbm", "polar_record", "lbm_record", "main"]

BASELINE_POINTS_PER_SEC = 1.0 / 30.0
BASELINE_LBM_MLUPS = 12.3
REYNOLDS = 1e6
FULL_ALPHAS = np.arange(-10.0, 20.5, 1.0, dtype=np.float32)     # 31 points
REDUCED_ALPHAS = np.arange(-4.0, 6.5, 1.0, dtype=np.float32)    # 11 points
FULL_REPS = 3
# (name, bench_mlups keywords): the throughput grid, the served grid and a
# grid past the resident kernel's capacity, at bench_mlups's defaults of
# 128 steps a call and 8 timed calls.
LBM_GRIDS = (("main", dict(nx=640, ny=384, steps_per_call=128, n_calls=8)),
             ("interactive", dict(nx=384, ny=192, steps_per_call=128,
                                  n_calls=8)),
             ("tiled", dict(nx=2048, ny=1024, steps_per_call=128,
                            n_calls=8)))
CPU_LBM_GRIDS = (("main", dict(nx=256, ny=128, steps_per_call=16,
                               n_calls=2)),)
_REPORT = os.path.join(os.path.dirname(__file__), "results",
                       "parity_report.json")


def _device_fields(dev: torch.device, card: str | None) -> dict:
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
            "card": card}


def polar_stats(out, seconds: float) -> dict:
    """``bench.py``'s polar summary of one ``PolarResult`` that took
    ``seconds``: points/s and the mode accounting (the share of points that
    carry a viscous answer, plain or on the smoothed geometry)."""
    mode = np.asarray(out.mode)
    n_points = int(mode.shape[0])
    n_visc = int(np.sum(mode == sweep.MODE_VISCOUS))
    n_smooth = int(np.sum(mode == sweep.MODE_VISCOUS_SMOOTHED))
    n_inv = int(np.sum(mode == sweep.MODE_INVISCID))
    return {
        "points_per_sec": n_points / seconds,
        "polar_seconds": seconds,
        "n_points": n_points,
        "viscous_fraction": (n_visc + n_smooth) / n_points,
        "mode_counts": {"viscous": n_visc, "viscous_smoothed": n_smooth,
                        "inviscid": n_inv},
    }


def _march_launches() -> dict:
    return {"bl_march": march_kernel.march_launches,
            "bl_march_wake": march_kernel.wake_launches}


def _graph_counts() -> dict:
    """Each solver program's graph captures and replays (LM iterations for
    ``"lm"``, calls for the others)."""
    return {prog: {"captures": graphs.total(graphs.captures, prog),
                   "replays": graphs.total(graphs.replays, prog)}
            for prog in graphs.PROGRAMS}


def bench_polar(reduced: bool = False, reps: int | None = None,
                device=None) -> dict:
    """The polar's summary (``polar_stats``) averaged over ``reps`` timed
    calls (default 3, 1 when ``reduced``), plus ``reps``, the warm-up's
    seconds (``warm_polar_kernels``, then one polar), and the march
    kernels' launches, the LM graphs' captures and iterations replayed
    (``lm_graphs``) and every solver program's captures and replays
    (``solver_graphs``) in the timed calls."""
    dev = resolve_device(device)
    coords = np.asarray(naca4(2, 4, 12, 100), np.float32)
    alphas = REDUCED_ALPHAS if reduced else FULL_ALPHAS
    if reps is None:
        reps = 1 if reduced else FULL_REPS
    if reps < 1:
        raise ValueError(f"reps must be at least 1, got {reps}")
    t0 = time.perf_counter()
    sweep.warm_polar_kernels(p=len(alphas) if reduced else 32, device=dev)
    t1 = time.perf_counter()
    # solve_polar returns host arrays: each call has finished on return.
    sweep.solve_polar(coords, alphas, REYNOLDS, device=dev)
    warmup = {"warm_polar_kernels": t1 - t0,
              "polar": time.perf_counter() - t1}
    before, graphs0 = _march_launches(), _graph_counts()
    t0 = time.perf_counter()
    for rep in range(reps):
        # Perturb the inputs so that no layer can serve a cached answer.
        out = sweep.solve_polar(coords, alphas + 0.001 * rep, REYNOLDS,
                                device=dev)
    dt = (time.perf_counter() - t0) / reps
    after, graphs1 = _march_launches(), _graph_counts()
    solver = {prog: {k: n - graphs0[prog][k] for k, n in c.items()}
              for prog, c in graphs1.items()}
    return dict(polar_stats(out, dt), reps=reps, warmup_seconds=warmup,
                launches={k: after[k] - before[k] for k in after},
                lm_graphs=solver["lm"], solver_graphs=solver)


def _parity_extra() -> dict:
    """The committed parity report's medians, converged share and truth
    (``airfoil_tpu_torch/bench/results/parity_report.json``, written by
    ``python3 -m airfoil_tpu_torch.bench.parity``): read, not recomputed."""
    with open(_REPORT) as f:
        parity = json.load(f)
    return {k: parity[k] for k in ("median_abs_cl_dev_pct",
                                   "median_abs_cd_dev_pct",
                                   "converged_fraction", "ground_truth")}


def polar_record(polar: dict, dev: torch.device, card: str | None) -> dict:
    """Line 1 from ``bench_polar``'s summary."""
    pps = polar["points_per_sec"]
    return {
        "metric": "viscous_polar_points_per_sec",
        "value": pps,
        "unit": "points/sec",
        "vs_baseline": pps / BASELINE_POINTS_PER_SEC,
        "extra": {**_device_fields(dev, card),
                  "n_points": polar["n_points"],
                  "polar_seconds_31pts": polar["polar_seconds"],
                  "viscous_fraction": polar["viscous_fraction"],
                  "mode_counts": polar["mode_counts"],
                  "reps": polar["reps"],
                  "warmup_seconds": polar["warmup_seconds"],
                  "launches": polar["launches"],
                  "lm_graphs": polar["lm_graphs"],
                  "solver_graphs": polar["solver_graphs"],
                  "parity": _parity_extra()},
    }


def _lbm_launches() -> dict:
    return {"lbm_steps": lbm_kernel.launches,
            "lbm_steps_tiled": lbm_kernel.tiled_launches,
            "cell_word": lbm_kernel.word_launches}


def bench_lbm(reduced: bool = False, device=None) -> dict:
    """{name: ``bench_mlups``'s result plus the launches of each LBM kernel
    in it} for each grid of ``LBM_GRIDS`` (``CPU_LBM_GRIDS`` when
    ``reduced``)."""
    dev = resolve_device(device)
    runs = {}
    for name, kw in CPU_LBM_GRIDS if reduced else LBM_GRIDS:
        before = _lbm_launches()
        r = bench_mlups(device=dev, **kw)
        after = _lbm_launches()
        runs[name] = dict(r, launches={k: after[k] - before[k]
                                       for k in after})
    return runs


def lbm_record(runs: dict, dev: torch.device, card: str | None) -> dict:
    """Line 2 from ``bench_lbm``'s runs: the main grid's MLUPS as the
    value, ``bench.py``'s keys for the other grids, and every grid's run
    (MLUPS, seconds, steps, the kernel that ran and its launches)."""
    main = runs["main"]
    extra = {**_device_fields(dev, card), "grid": main["grid"],
             "steps": main["steps"]}
    for name in ("interactive", "tiled"):
        if name in runs:
            extra[f"{name}_grid"] = runs[name]["grid"]
            extra[f"{name}_mlups"] = runs[name]["mlups"]
    extra["runs"] = {name: {k: r[k] for k in ("grid", "mlups", "seconds",
                                              "steps", "kernel", "tiled",
                                              "launches")}
                     for name, r in runs.items()}
    return {"metric": "lbm_mlups", "value": main["mlups"], "unit": "MLUPS",
            "vs_baseline": main["mlups"] / BASELINE_LBM_MLUPS,
            "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs the reduced "
                         "configuration")
    ap.add_argument("--reps", type=int, default=None,
                    help=f"timed polar repetitions (default {FULL_REPS}; 1 "
                         f"on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reduced = dev.type != "cuda"
    card = None if reduced else card_name()
    polar = bench_polar(reduced=reduced, reps=args.reps, device=dev)
    print(json.dumps(polar_record(polar, dev, card)), flush=True)
    print(json.dumps(lbm_record(bench_lbm(reduced, dev), dev, card)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
