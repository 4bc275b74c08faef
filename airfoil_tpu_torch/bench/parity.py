"""Parity harness: the port's polar coefficients against XFOIL anchors.

Port of ``airfoil_tpu/bench/parity.py``. Two ground-truth sources, in
preference order, as the reference's:

1. a live XFOIL binary (``XFOIL_PATH`` or ``xfoil`` on ``PATH``), run per
   anchor through ``airfoil_tpu_torch.interop.run_xfoil_if_available``;
   its answer is exact (an uncertainty band of 0);
2. the vendored anchor dataset ``data/xfoil_truth.json`` (a byte copy of
   the reference's: XFOIL 6.96 ncrit=9 polar anchors with a per-point
   uncertainty band; see its provenance notes).

Each point's ``truth_source`` says which (``xfoil_binary`` or
``vendored_table``); ``ground_truth`` is ``live xfoil`` when any point used
the binary.

Each (airfoil, Re) group of anchors is solved through the product path, a
whole ``solve_polar`` over a 0.5-degree grid from -2 degrees that holds
every anchor alpha; the report has the reference's keys and aggregates,
plus ``timing``: each polar's lanes, wall seconds, the continuation
walk's solves and march launches, with the device it ran on. The CLI also
times the reference bench's polar (``bench_polar``) and names the card and
its power limit (``card``).

CLI: python -m airfoil_tpu_torch.bench.parity [--out parity_report.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["run_parity", "load_truth", "bench_polar"]

_DATA = os.path.join(os.path.dirname(__file__), "data", "xfoil_truth.json")

_DIGITS = {"naca0012": (0, 0, 12), "naca2412": (2, 4, 12),
           "naca4412": (4, 4, 12)}


def load_truth() -> dict:
    """The vendored anchor dataset, keyed by (airfoil, Re, alpha)."""
    with open(_DATA) as f:
        data = json.load(f)
    return {
        (p["airfoil"], float(p["reynolds"]), float(p["alpha"])): p
        for p in data["points"]
    }


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed_polar(name: str, alphas, re_, device):
    """One ``solve_polar`` of ``name`` (100 points a side) on ``device``, the
    march kernels loaded first. Returns (the result, a timing record: lanes,
    wall seconds, points/s, the walk's solves, march launches, modes)."""
    from airfoil_tpu_torch.models import naca4
    from airfoil_tpu_torch.polar import sweep
    from airfoil_tpu_torch.viscous import kernel

    if device.type == "cuda":
        kernel.load()
    before = (dict(sweep.walk_solves), kernel.march_launches,
              kernel.wake_launches)
    t0 = time.perf_counter()
    res = sweep.solve_polar(np.asarray(naca4(*_DIGITS[name], 100),
                                       np.float32),
                            np.asarray(alphas, np.float32), re_,
                            device=device)
    secs = time.perf_counter() - t0
    timing = {"airfoil": name, "reynolds": re_, "points": len(alphas),
              "lanes": sweep._bucket_size(len(alphas)), "seconds": secs,
              "points_per_s": len(alphas) / secs,
              **{f"{k}_solves": sweep.walk_solves[k] - before[0][k]
                 for k in before[0]},
              "side_launches": kernel.march_launches - before[1],
              "wake_launches": kernel.wake_launches - before[2],
              "modes": {str(m): int(np.sum(res.mode == m))
                        for m in (0, 1, 2)}}
    return res, timing


def _solve_polar_points(name: str, re_: float, alphas, device):
    """Solve the anchor points through the product path, a full polar via
    ``solve_polar``, whose continuation walk audits each point against the
    local trend. Returns ({alpha: (cl, cd, viscous)}, timing record)."""
    from airfoil_tpu_torch.polar import sweep

    hi = max(9.0, max(float(a) for a in alphas))
    grid = sorted(set(np.arange(-2.0, hi + 0.01, 0.5).tolist())
                  | {float(a) for a in alphas})
    res, timing = _timed_polar(name, grid, re_, device)
    out = {}
    garr = np.asarray(grid)
    for a in alphas:
        # Exact membership: every anchor is on the grid bit-exactly.
        matches = np.nonzero(np.abs(garr - a) < 1e-9)[0]
        assert matches.size == 1, f"anchor alpha {a} not on the polar grid"
        i = int(matches[0])
        out[a] = (float(res.cl[i]), float(res.cd[i]),
                  int(res.mode[i]) == sweep.MODE_VISCOUS)
    return out, timing


def bench_polar(device=None) -> dict:
    """The timing record of the reference bench's polar (``bench.py``:
    NACA 2412, 100 points a side, alpha -10..20 step 1, Re 1e6)."""
    from airfoil_tpu_torch.device import resolve_device

    _res, timing = _timed_polar("naca2412", np.arange(-10.0, 21.0), 1e6,
                                resolve_device(device))
    return timing


def _xfoil_truth(name: str, re_: float, alpha: float):
    """(CL, CD) of a live XFOIL run of the anchor's section, or ``None``
    when no binary is found or its run fails."""
    from airfoil_tpu_torch.interop import run_xfoil_if_available
    from airfoil_tpu_torch.models import naca4

    with tempfile.TemporaryDirectory() as wd:
        path = os.path.join(wd, f"{name}.dat")
        coords = naca4(*_DIGITS[name], 100)
        with open(path, "w") as f:
            f.write(f"{name}\n")
            for x, y in coords:
                f.write(f" {x:.6f} {y:.6f}\n")
        out = run_xfoil_if_available(path, re_, alpha, wd)
    if out is None:
        return None
    coeffs = out[0]
    return coeffs.get("CL"), coeffs.get("CD")


def run_parity(use_live_xfoil: bool = True, device=None) -> dict:
    """Every anchor group's polar on ``device`` (see ``resolve_device``)
    against a live XFOIL's answer where one runs (``use_live_xfoil``), else
    the vendored table."""
    from airfoil_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    anchors = load_truth()
    points = []
    live_used = False
    groups = {}
    for (name, re_, alpha) in anchors:
        groups.setdefault((name, re_), []).append(alpha)
    solved, timing = {}, []
    for key, alphas in groups.items():
        solved[key], t = _solve_polar_points(key[0], key[1], alphas, dev)
        timing.append(t)
        print(json.dumps(t), file=sys.stderr, flush=True)
    for (name, re_, alpha), anchor in anchors.items():
        truth = _xfoil_truth(name, re_, alpha) if use_live_xfoil else None
        source = "xfoil_binary" if truth else "vendored_table"
        live_used = live_used or truth is not None
        cl_ref, cd_ref = truth if truth else (anchor["cl"], anchor["cd"])
        cl, cd, converged = solved[(name, re_)][alpha]
        cl_dev = (100 * (cl - cl_ref) / abs(cl_ref)
                  if abs(cl_ref) > 0.02 else None)
        cd_dev = 100 * (cd - cd_ref) / cd_ref if cd_ref else None
        # Measurability: is the deviation inside the anchor's own
        # uncertainty band? (Live-XFOIL truth is exact: band = 0.)
        unc_cl = 0.0 if truth else anchor.get("unc_cl", 0.0)
        unc_cd = 0.0 if truth else anchor.get("unc_cd_rel", 0.0)
        within = (abs(cl - cl_ref) <= unc_cl
                  and (not cd_ref
                       or abs(cd - cd_ref) <= unc_cd * cd_ref))
        points.append({
            "airfoil": name, "reynolds": re_, "alpha": alpha,
            "cl": round(cl, 4), "cl_ref": cl_ref,
            "cd": round(cd, 5), "cd_ref": cd_ref,
            "cl_dev_pct": round(cl_dev, 1) if cl_dev is not None else None,
            "cd_dev_pct": round(cd_dev, 1) if cd_dev is not None else None,
            "unc_cl": unc_cl, "unc_cd_rel": unc_cd,
            "within_unc": bool(within),
            "converged": converged, "truth_source": source,
        })
    cl_devs = [abs(p["cl_dev_pct"]) for p in points
               if p["cl_dev_pct"] is not None and p["converged"]]
    cd_devs = [abs(p["cd_dev_pct"]) for p in points
               if p["cd_dev_pct"] is not None and p["converged"]]
    # All-anchor CD metric: an unconverged anchor (served as an inviscid
    # fill with CD = 0) counts as 100% error.
    cd_devs_all = [abs(p["cd_dev_pct"]) if p["converged"] else 100.0
                   for p in points if p["cd_dev_pct"] is not None]
    # Envelope coverage: max converged alpha per (airfoil, Re) group.
    env = {}
    for p in points:
        key = f"{p['airfoil']}@{p['reynolds']:.0e}"
        if p["converged"]:
            env[key] = max(env.get(key, -99.0), p["alpha"])
        else:
            env.setdefault(key, -99.0)
    return {
        "points": points,
        "median_abs_cl_dev_pct": round(float(np.median(cl_devs)), 1)
        if cl_devs else None,
        "median_abs_cd_dev_pct": round(float(np.median(cd_devs)), 1)
        if cd_devs else None,
        "median_abs_cd_dev_all_anchors_pct": round(
            float(np.median(cd_devs_all)), 1) if cd_devs_all else None,
        "max_converged_alpha": env,
        "converged_fraction": round(
            float(np.mean([p["converged"] for p in points])), 2),
        "within_unc_fraction": round(
            float(np.mean([p["within_unc"] for p in points])), 2),
        "ground_truth": "live xfoil" if live_used else
        "vendored dataset bench/data/xfoil_truth.json (XFOIL 6.96 "
        "ncrit=9 anchors with per-point uncertainty; see its provenance "
        "notes)",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "timing": timing,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="parity_report.json")
    args = ap.parse_args()
    # Build the kernel libraries before the first polar, as the reference
    # turns on its compile cache.
    from airfoil_tpu_torch.utils.compile_cache import (
        enable_persistent_compile_cache,
    )
    enable_persistent_compile_cache()
    report = run_parity()
    report["bench_polar"] = bench_polar()
    print(json.dumps(report["bench_polar"]), file=sys.stderr, flush=True)
    if torch.cuda.is_available():
        report["card"] = card()
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
