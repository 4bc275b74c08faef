"""Classify why both-failed airfoils failed, geometrically.

(A copy of ``airfoil_tpu/bench/classify_failures.py``, wired to the port's
parser and ``raw_coords_from_file``.)

Re-implementation of the reference's failure classifier
(benchmark/classify_failures.py): categories multi_element /
too_few_points / non_monotone_surface / lednicer_hard / extreme_geometry
(camber > 12% or thickness > 30%) / convergence_failure, applied to the
rows of ``benchmark_results.csv`` where both solve paths failed.

CLI: python -m airfoil_tpu_torch.bench.classify_failures --csv results.csv \
        --data-dir corpus/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from collections import Counter

from airfoil_tpu_torch.bench.parser_benchmark import raw_coords_from_file
from airfoil_tpu_torch.geometry.multielement import is_multi_element

__all__ = ["classify_failure"]


def _le_split(coords):
    xs = [c[0] for c in coords]
    le = min(range(len(xs)), key=lambda i: xs[i])
    return le, xs


def has_non_monotone_surface(coords) -> bool:
    """Either surface's x distribution reverses — self-intersecting or
    badly ordered coordinates (reference classify_failures.py:93-109)."""
    if len(coords) < 6:
        return False
    le, xs = _le_split(coords)
    upper_x = xs[: le + 1]
    lower_x = xs[le:]
    upper_mono = all(upper_x[i] >= upper_x[i + 1] - 1e-4
                     for i in range(len(upper_x) - 1))
    lower_mono = all(lower_x[i] <= lower_x[i + 1] + 1e-4
                     for i in range(len(lower_x) - 1))
    return not (upper_mono and lower_mono)


def is_lednicer(coords) -> bool:
    xs = [c[0] for c in coords]
    return any(xs[i] < 0.01 and xs[i - 1] > 0.5 for i in range(1, len(xs)))


def estimate_camber_thickness(coords):
    """Rough max camber / thickness from upper-lower midpoints."""
    if len(coords) < 6:
        return 0.0, 0.0
    le, _xs = _le_split(coords)
    upper = {round(c[0], 2): c[1] for c in coords[: le + 1]}
    lower = {round(c[0], 2): c[1] for c in coords[le:]}
    cambers, thicknesses = [], []
    for x, yu in upper.items():
        if x in lower:
            yl = lower[x]
            cambers.append(abs(yu + yl) / 2)
            thicknesses.append(abs(yu - yl))
    return (max(cambers) if cambers else 0.0,
            max(thicknesses) if thicknesses else 0.0)


def classify_failure(coords) -> str:
    """Category for one failed airfoil's raw coordinates."""
    if len(coords) < 10:
        return "too_few_points"
    if is_multi_element(coords):
        return "multi_element"
    camber, thickness = estimate_camber_thickness(coords)
    if camber > 0.12 or thickness > 0.30:
        return "extreme_geometry"
    if is_lednicer(coords):
        return "lednicer_hard"
    if has_non_monotone_surface(coords):
        return "non_monotone"
    return "convergence_failure"


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", required=True,
                    help="benchmark_results.csv from parser_benchmark")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_dir = args.out or os.path.dirname(os.path.abspath(args.csv))

    with open(args.csv) as f:
        rows = list(csv.DictReader(f))
    failed = [r for r in rows
              if r["raw_converged"] == "False"
              and r["parsed_converged"] == "False"]

    out_rows = []
    for r in failed:
        path = os.path.join(args.data_dir, r["name"])
        coords = raw_coords_from_file(path) if os.path.exists(path) else []
        out_rows.append({"name": r["name"],
                         "category": classify_failure(coords)})

    counts = Counter(r["category"] for r in out_rows)
    with open(os.path.join(out_dir, "failure_classification.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "category"])
        w.writeheader()
        w.writerows(out_rows)
    with open(os.path.join(out_dir, "failure_summary.txt"), "w") as f:
        f.write(f"both-failed files: {len(out_rows)}\n")
        for cat, cnt in counts.most_common():
            f.write(f"{cat:>22}: {cnt}\n")
    print(json.dumps(dict(counts), indent=2))


if __name__ == "__main__":
    main()
