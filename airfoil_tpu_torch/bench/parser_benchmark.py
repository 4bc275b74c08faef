"""Parser-robustness benchmark: raw vs repaired solve success over a corpus.

Port of ``airfoil_tpu/bench/parser_benchmark.py``, the re-creation of the
reference's headline validation (benchmark/airfoil_parser_benchmark.py —
raw XFOIL 22.5% vs parsed 85.7% on 1,000 UIUC files). As there:

- the solver is the framework's coupled viscous solve, not an XFOIL
  subprocess;
- the "raw" path takes every numeric pair in file order with NO repairs
  (no Lednicer merge, no winding fix, no range filter);
- a path succeeds when the solve at the benchmark operating point (Re
  200k, alpha 5) gives plausible coefficients (finite, |CL| < 2.5,
  1e-4 < CD < 0.08, separated fraction < 0.5), not on the strict
  convergence flag; a multi-element file fails both paths.

Geometries are resampled to 121 points by arc length and solved in chunks
of 32 (the last padded by repeating its last geometry), each chunk one
lane-batched pass through ``repanel`` -> ``build_operator`` ->
``solve_viscous`` on the device (the reference's ``vmap``): 32 operators
built and LU-factored as one batch, then 17 side-march launches of 64
lanes and 17 wake launches of 32, and one host read of the chunk's
verdicts.

Outputs: ``benchmark_results.csv``, ``benchmark_summary.json`` and ``.txt``
with the reference's fields, plus ``device`` and ``card`` (the card's name
and power limit as ``nvidia-smi`` gives them). Partial results are written
on interrupt.

CLI (on the card):
    python -m airfoil_tpu_torch.bench.parser_benchmark --out results/ \\
        [--data-dir UIUC_DIR | --synthetic N] [--limit N]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.geometry import parse_dat_file, AirfoilParseError
from airfoil_tpu_torch.geometry.multielement import is_multi_element
from airfoil_tpu_torch.inviscid.programs import operator_program
from airfoil_tpu_torch.viscous import solve_viscous

__all__ = ["run_benchmark", "raw_coords_from_file"]

BENCH_REYNOLDS = 2e5   # reference benchmark condition (Re=200,000)
BENCH_ALPHA = 5.0      # alpha = 5 deg
N_PANELS = 128
CHUNK = 32
RESAMPLE_POINTS = 121
SOLVE_SHAPE = {"n_stations": 64, "n_wake": 16, "coupling_iters": 16}


def raw_coords_from_file(path: str):
    """The no-repair tokenisation: every numeric pair, file order.

    This is what XFOIL itself effectively sees when the reference feeds a
    file verbatim (test_raw, airfoil_parser_benchmark.py:387-395).
    """
    coords = []
    with open(path, errors="ignore") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                coords.append([float(parts[0]), float(parts[1])])
            except ValueError:
                continue
    return coords


def resample(geometries) -> tuple[np.ndarray, list[bool]]:
    """Every geometry at ``RESAMPLE_POINTS`` points by arc length, so that
    chunks stack: (G, 121, 2) float32, and which geometries had a loop to
    resample (the others are zeros)."""
    m = RESAMPLE_POINTS
    norm, ok_mask = [], []
    for g in geometries:
        if g is None or len(g) < 5:
            norm.append(np.zeros((m, 2), np.float32))
            ok_mask.append(False)
            continue
        g = np.asarray(g, np.float64)
        seg = np.hypot(np.diff(g[:, 0]), np.diff(g[:, 1]))
        arc = np.concatenate([[0], np.cumsum(seg)])
        if arc[-1] < 1e-9:
            norm.append(np.zeros((m, 2), np.float32))
            ok_mask.append(False)
            continue
        s = np.linspace(0, arc[-1], m)
        norm.append(np.stack([np.interp(s, arc, g[:, 0]),
                              np.interp(s, arc, g[:, 1])], 1).astype(np.float32))
        ok_mask.append(True)
    return np.stack(norm), ok_mask


def chunks(batch_arr: np.ndarray):
    """(chunk (CHUNK, M, 2), lanes that are files) in order; the last chunk
    padded by repeating its last geometry."""
    for i in range(0, len(batch_arr), CHUNK):
        chunk = batch_arr[i:i + CHUNK]
        pad = CHUNK - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        yield chunk, CHUNK - pad


def chunk_operators(chunk: np.ndarray, device):
    """The chunk's inviscid operators, one lane a geometry (the program
    ``"operator"`` at the chunk's key)."""
    return operator_program(torch.as_tensor(chunk, device=device),
                            N_PANELS)[0]


def solve_chunk(ops, reynolds=BENCH_REYNOLDS, x_forced_transition=1.0):
    """The benchmark's solve of every lane of ``ops``."""
    return solve_viscous(ops, BENCH_ALPHA, reynolds,
                         x_forced_transition=x_forced_transition,
                         **SOLVE_SHAPE)


def plausible(r) -> torch.Tensor:
    """Success is judged on physical plausibility rather than the strict
    convergence flag: at the benchmark's Re=200k the flag is conservative
    even on clean geometry, while broken geometries (unmerged Lednicer,
    reversed winding, scrambled ordering) produce NaNs or wildly
    implausible coefficients — the same discrimination XFOIL's
    converged/diverged gives the reference."""
    return (torch.isfinite(r.cl) & torch.isfinite(r.cd)
            & (torch.abs(r.cl) < 2.5) & (r.cd > 1e-4) & (r.cd < 0.08)
            & (r.sep_fraction < 0.5))


def _batched_success(geometries: list, device=None) -> list[bool]:
    """Plausible solve per geometry, solved in lane-batched chunks."""
    dev = resolve_device(device)
    batch_arr, ok_mask = resample(geometries)
    results: list[bool] = []
    for chunk, n in chunks(batch_arr):
        out = plausible(solve_chunk(chunk_operators(chunk, dev))).cpu()
        results.extend(bool(b) for b in out[:n])
    return [r and m for r, m in zip(results, ok_mask)]


def card_of(dev: torch.device) -> str:
    """The card's name and power limit, or the device type off the card."""
    if dev.type != "cuda":
        return dev.type
    from airfoil_tpu_torch.bench.parity import card
    return card()


def run_benchmark(files: list[str], out_dir: str,
                  corpus: str = "synthetic", device=None) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    t_start = time.time()

    rows = []
    raw_geoms, parsed_geoms = [], []
    for path in files:
        name = os.path.basename(path)
        raw = raw_coords_from_file(path)
        try:
            parsed, fixes = parse_dat_file(path)
            parse_error, parse_code = "", ""
        except AirfoilParseError as e:
            parsed, fixes, parse_error = None, [], e.detail
            parse_code = e.code
        # Multi-element probe on the PARSED loop (a raw Lednicer stream
        # counts two LE passes; the reference also probes after parsing,
        # airfoil_parser_benchmark.py:502-507).
        multi = is_multi_element(parsed if parsed else raw)
        rows.append({
            "name": name, "multi_element": multi,
            "n_raw": len(raw), "n_parsed": len(parsed) if parsed else 0,
            "fixes": "; ".join(fixes), "parse_error": parse_error,
            "parse_error_code": parse_code,
        })
        raw_geoms.append(np.asarray(raw) if len(raw) >= 5 else None)
        parsed_geoms.append(np.asarray(parsed) if parsed else None)

    try:
        raw_ok = _batched_success(raw_geoms, dev)
        parsed_ok = _batched_success(parsed_geoms, dev)
    except KeyboardInterrupt:  # partial results still get written
        raw_ok = [False] * len(files)
        parsed_ok = [False] * len(files)

    for row, r_ok, p_ok in zip(rows, raw_ok, parsed_ok):
        if row["multi_element"]:
            r_ok = p_ok = False
        row["raw_converged"] = r_ok
        row["parsed_converged"] = p_ok
        row["rescued"] = (not r_ok) and p_ok
        row["regressed"] = r_ok and (not p_ok)

    n = len(rows)
    single = [r for r in rows if not r["multi_element"]]
    raw_n = sum(r["raw_converged"] for r in rows)
    parsed_n = sum(r["parsed_converged"] for r in rows)
    rescued = sum(r["rescued"] for r in rows)
    regressed = sum(r["regressed"] for r in rows)
    both_failed = sum(
        1 for r in rows
        if not r["raw_converged"] and not r["parsed_converged"])
    # Expected rejections (files the reference parser also refuses by
    # rule: < 10 valid points) are not parser failures.
    degenerate = sum(1 for r in rows
                     if r.get("parse_error_code") == "too_few_points")
    parser_errors = sum(1 for r in rows if r["parse_error"]) - degenerate

    summary = {
        "n_files": n,
        "n_multi_element": n - len(single),
        "reynolds": BENCH_REYNOLDS,
        "alpha": BENCH_ALPHA,
        "raw_converged": raw_n,
        "raw_pct": round(100 * raw_n / max(n, 1), 1),
        "parsed_converged": parsed_n,
        "parsed_pct": round(100 * parsed_n / max(n, 1), 1),
        "rescued": rescued,
        "rescued_pct": round(100 * rescued / max(n, 1), 1),
        "uplift_pp": round(100 * (parsed_n - raw_n) / max(n, 1), 1),
        "regressed": regressed,
        "both_failed": both_failed,
        "parser_errors": parser_errors,
        "degenerate_rejected": degenerate,
        "corpus": corpus,
        "elapsed_seconds": round(time.time() - t_start, 1),
        "device": dev.type,
        "card": card_of(dev),
    }

    csv_path = os.path.join(out_dir, "benchmark_results.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    with open(os.path.join(out_dir, "benchmark_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(out_dir, "benchmark_summary.txt"), "w") as f:
        f.write("PARSER ROBUSTNESS BENCHMARK\n")
        f.write("=" * 40 + "\n")
        for k, v in summary.items():
            f.write(f"{k:>20}: {v}\n")
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="benchmark_out")
    ap.add_argument("--data-dir", default=None,
                    help="directory of real .dat files (e.g. UIUC database)")
    ap.add_argument("--synthetic", type=int, default=200,
                    help="generate this many synthetic files when no "
                         "--data-dir is given")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args()

    if args.data_dir:
        from airfoil_tpu_torch.bench.uiuc import corpus_kind

        corpus = corpus_kind(args.data_dir)
        files = sorted(
            os.path.join(r, f)
            for r, _d, fs in os.walk(args.data_dir)
            for f in fs if f.lower().endswith(".dat"))
    else:
        corpus = "synthetic"
        from airfoil_tpu_torch.bench.corpus import generate_corpus

        files = generate_corpus(os.path.join(args.out, "corpus"),
                                n=args.synthetic)
    if args.limit:
        files = files[: args.limit]
    summary = run_benchmark(files, args.out, corpus=corpus)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
