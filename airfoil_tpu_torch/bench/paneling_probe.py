"""Paneling / convergence diagnostic probe.

Port of ``airfoil_tpu/bench/paneling_probe.py``, the analog of the
reference's standalone diagnostic CLI ``xfoil_paneling_test.py`` (reference
:1-310), which tries four XFOIL command strategies (baseline PANE / ALFA-0
pre-step / PPAR 160 / PPAR 220 with LE bunching T 1.5) against one
difficult airfoil and reports the first that converges.

The strategies map onto the knobs this framework actually has:

1. ``baseline``    — 160 panels, LE/TE-clustered 'airfoil' spacing,
                     standard coupling budget (the service default).
2. ``more-iters``  — same paneling, doubled coupling budget (the analog
                     of the reference's ALFA-0 warm-up step: spend more
                     solver effort, not different geometry).
3. ``fine-160u``   — 160 panels, plain cosine spacing (the reference's
                     PPAR 160 re-panel without LE bunching).
4. ``fine-220``    — 220 panels with LE/TE clustering (PPAR 220 + T 1.5).
5. ``smoothed``    — Taubin-smoothed geometry at the baseline paneling
                     (the GDES SMOO rescue, strategy 2 of the service).

Each strategy is one ``solve_viscous`` on the device (the card unless
``device`` names another).

Usage (on the card):
  python -m airfoil_tpu_torch.bench.paneling_probe foil.dat [--reynolds 2e5]
      [--alpha 5] [--json out.json]
  python -m airfoil_tpu_torch.bench.paneling_probe --naca 6409 ...
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.inviscid import build_operator
from airfoil_tpu_torch.paneling import panel_geometry, repanel, smooth_geometry
from airfoil_tpu_torch.viscous import solve_viscous

__all__ = ["probe_strategies", "STRATEGIES", "PLANS"]

STRATEGIES = ("baseline", "more-iters", "fine-160u", "fine-220", "smoothed")
PLANS = {
    "baseline":   dict(),
    "more-iters": dict(coupling_iters=48),
    "fine-160u":  dict(spacing="cosine"),
    "fine-220":   dict(n_panels=220),
    "smoothed":   dict(smooth=True),
}


def _solve_with(coords, alpha, reynolds, *, n_panels=160, spacing="airfoil",
                smooth=False, coupling_iters=24, device=None):
    xp, yp = repanel(np.asarray(coords, np.float32), n_panels,
                     spacing=spacing, device=resolve_device(device))
    if smooth:
        xp, yp = smooth_geometry(xp, yp)
    op = build_operator(panel_geometry(xp, yp))
    return solve_viscous(op, float(alpha), float(reynolds),
                         coupling_iters=coupling_iters)


def probe_strategies(coords, alpha: float, reynolds: float,
                     device=None) -> list[dict]:
    """Run all strategies; return one report row per strategy."""
    rows = []
    for name in STRATEGIES:
        t0 = time.perf_counter()
        try:
            r = _solve_with(coords, alpha, reynolds, device=device,
                            **PLANS[name])
            cl = float(r.cl)
            # A bool (the reference's is a numpy bool, which --json cannot
            # write).
            ok = bool(r.converged) and bool(np.isfinite(cl))
            rows.append({
                "strategy": name,
                "converged": ok,
                "CL": round(cl, 4),
                "CD": round(float(r.cd), 5),
                "Cm": round(float(r.cm), 4),
                "sep_fraction": round(float(r.sep_fraction), 3),
                "seconds": round(time.perf_counter() - t0, 2),
            })
        except Exception as e:  # surface, don't abort the probe
            rows.append({"strategy": name, "converged": False,
                         "error": f"{type(e).__name__}: {e}",
                         "seconds": round(time.perf_counter() - t0, 2)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dat", nargs="?", help=".dat coordinate file")
    ap.add_argument("--naca", help="4-digit NACA code instead of a file")
    ap.add_argument("--reynolds", type=float, default=2e5)
    ap.add_argument("--alpha", type=float, default=5.0)
    ap.add_argument("--json", help="also write the report to this path")
    args = ap.parse_args(argv)

    if args.naca:
        from airfoil_tpu_torch.models import naca4

        d = args.naca
        coords = np.asarray(naca4(int(d[0]), int(d[1]), int(d[2:]), 100))
        name = f"NACA {d}"
    elif args.dat:
        from airfoil_tpu_torch.geometry import parse_dat_file

        coords, fixes = parse_dat_file(args.dat)
        coords = np.asarray(coords)
        name = args.dat
        for f in fixes:
            print(f"  parser: {f}")
    else:
        ap.error("give a .dat file or --naca NNNN")

    print(f"Probing {name} at Re={args.reynolds:g}, alpha={args.alpha:g} deg")
    rows = probe_strategies(coords, args.alpha, args.reynolds)

    first_ok = None
    for row in rows:
        status = "CONVERGED" if row.get("converged") else "failed   "
        extras = (f"CL={row.get('CL')} CD={row.get('CD')} "
                  f"sep={row.get('sep_fraction')}"
                  if "CL" in row else row.get("error", ""))
        print(f"  [{status}] {row['strategy']:<10} "
              f"({row['seconds']:5.2f}s)  {extras}")
        if first_ok is None and row.get("converged"):
            first_ok = row["strategy"]

    if first_ok:
        print(f"First working strategy: {first_ok}")
    else:
        print("No strategy converged — inviscid fallback would be served "
              "(service strategy 3, reference main.py:314-325).")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"airfoil": name, "alpha": args.alpha,
                       "reynolds": args.reynolds, "rows": rows,
                       "first_working": first_ok}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
