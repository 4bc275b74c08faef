"""Classify which repair mechanisms rescued each file.

(A copy of ``airfoil_tpu/bench/classify_repairs.py``, wired to the port's
parser.)

Re-implementation of the reference's repair classifier
(benchmark/classify_repairs.py), with a structural improvement: the
reference re-detects each mechanism from the raw file with standalone
heuristics mapped 1:1 to parser branches (its docstrings cite the code
lines); here the parser's own machine-readable fixes log is the source of
truth, so classification cannot drift from the implementation.

Mechanisms (same six as the reference):
  lednicer_to_selig, winding_fixed, le_dedup, closed_te_preserved,
  range_filter, line_skip

CLI: python -m airfoil_tpu_torch.bench.classify_repairs --csv results.csv \
        --data-dir corpus/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from collections import Counter

from airfoil_tpu_torch.geometry import parse_dat_file, AirfoilParseError

__all__ = ["classify_repairs", "MECHANISMS"]

MECHANISMS = [
    "lednicer_to_selig",
    "winding_fixed",
    "le_dedup",
    "closed_te_preserved",
    "range_filter",
    "line_skip",
]

_FIX_MARKERS = {
    "lednicer_to_selig": "Lednicer format detected",
    "winding_fixed": "Winding order corrected",
    "le_dedup": "Duplicate leading-edge point removed",
    "range_filter": "Out-of-range points filtered",
    "line_skip": "Non-coordinate lines skipped",
}


def classify_repairs(path: str) -> dict[str, bool]:
    """Which repair mechanisms fired for this file (from the fixes log)."""
    flags = {m: False for m in MECHANISMS}
    try:
        coords, fixes = parse_dat_file(path)
    except AirfoilParseError:
        return flags
    joined = " | ".join(fixes)
    for mech, marker in _FIX_MARKERS.items():
        flags[mech] = marker in joined
    # Closed-TE preservation is a non-action the fixes log doesn't record:
    # detect it directly (first == last point retained in the output).
    if len(coords) >= 2:
        flags["closed_te_preserved"] = (
            abs(coords[0][0] - coords[-1][0]) < 1e-3
            and abs(coords[0][1] - coords[-1][1]) < 1e-3
        )
    return flags


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_dir = args.out or os.path.dirname(os.path.abspath(args.csv))

    with open(args.csv) as f:
        rows = list(csv.DictReader(f))
    rescued = [r for r in rows if r["rescued"] == "True"]

    out_rows = []
    totals = Counter()
    for r in rescued:
        path = os.path.join(args.data_dir, r["name"])
        flags = classify_repairs(path) if os.path.exists(path) else \
            {m: False for m in MECHANISMS}
        totals.update([m for m, v in flags.items() if v])
        out_rows.append({"name": r["name"], **flags})

    with open(os.path.join(out_dir, "repair_classification.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name"] + MECHANISMS)
        w.writeheader()
        w.writerows(out_rows)
    with open(os.path.join(out_dir, "repair_summary.txt"), "w") as f:
        f.write(f"rescued files: {len(out_rows)}\n")
        for mech in MECHANISMS:
            f.write(f"{mech:>22}: {totals.get(mech, 0)}\n")
    print(json.dumps({m: totals.get(m, 0) for m in MECHANISMS}, indent=2))


if __name__ == "__main__":
    main()
