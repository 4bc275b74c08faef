"""Write ``tests/golden/torch_bench.json``: the JAX package's parser
benchmark and paneling probe on the CPU, for the holds of
``chip_smoke.py``'s parser-bench and probe phases on the GPU machine.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_bench_goldens.py

(about 10 minutes; run it in the background). The corpus is
``generate_corpus(n=500, seed=0)`` in a temporary directory. The file
holds:

- ``members``: the benchmark's solve (``bench/parser_benchmark.py::
  _batched_success``: the arc-length resample to 121 points, chunks of 32
  padded with the last geometry, ``repanel`` -> ``build_operator`` ->
  ``solve_viscous`` under ``vmap`` with 64 stations, 16 wake stations and
  16 coupling passes) at Re (1 + k 2^-23), k = -1, 0, +1 (Re the
  benchmark's 2e5), each driven through the reference's own
  ``run_benchmark`` (its rows, multi-element override and summary). Per
  member and path (raw, parsed), one list a field over the 500 files: CL,
  CD, Cm, ``sep_fraction``, ``converged``, the transition x of each side,
  the solver's plausibility verdict and the row's final verdict; and the
  member's summary;
- ``reference``: the summary and final verdicts of the reference's
  ``run_benchmark`` itself, unpatched (k = 0), and how many verdicts the
  k = 0 member differs from it by;
- ``flip_rate``: S, the most verdicts on which one member differs from
  both others, over the three members (the reference's own flip rate);
- ``tripped``: the first raw chunk and the first parsed chunk (files 0-31)
  tripped at x = 0.05, the same fields, k = -1, 0, +1;
- ``probe``: ``bench/paneling_probe.py``'s five plans for NACA 2412
  (``--naca 2412``) and for ``af0001_thick_te_lednicer.dat`` (the
  corpus's second file), at Re 2e5 (1 + k 2^-23) and alpha 5: the probe's
  verdict (``converged`` and a finite CL), CL, CD, Cm and
  ``sep_fraction``.

The direct solve at the benchmark's operating point is a knife edge: a
one-ulp change of Re moves some files' CD severalfold and flips their
verdicts, so the port is held to the members' spread, not to one run.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from airfoil_tpu.bench import paneling_probe as jprobe
from airfoil_tpu.bench import parser_benchmark as jpb
from airfoil_tpu.bench.corpus import generate_corpus
from airfoil_tpu.geometry import parse_dat_file
from airfoil_tpu.inviscid import build_operator
from airfoil_tpu.models import naca4
from airfoil_tpu.paneling import panel_geometry, repanel
from airfoil_tpu.viscous import solve_viscous

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_bench.json")
N_FILES, SEED = 500, 0
MEMBERS_K = (-1, 0, 1)
TRIP_X = 0.05
SOLVE_SHAPE = {"n_stations": 64, "n_wake": 16, "coupling_iters": 16}
RESAMPLE_POINTS = 121
FIELDS = ("cl", "cd", "cm", "sep_fraction", "converged", "xtr_upper",
          "xtr_lower", "plausible")
PATHS = ("raw", "parsed")
# bench/paneling_probe.py::probe_strategies's plans.
PROBE_PLANS = {
    "baseline": dict(),
    "more-iters": dict(coupling_iters=48),
    "fine-160u": dict(spacing="cosine"),
    "fine-220": dict(n_panels=220),
    "smoothed": dict(smooth=True),
}
PROBE_ALPHA = 5.0


def member_re(k: int) -> float:
    return float(jpb.BENCH_REYNOLDS * (1.0 + k * 2.0 ** -23))


def resample(geometries):
    """``_batched_success``'s resample: (G, 121, 2) float32 and the mask
    of geometries that had one."""
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
                              np.interp(s, arc, g[:, 1])],
                             1).astype(np.float32))
        ok_mask.append(True)
    return np.stack(norm), ok_mask


def chunk_solver(re: float, x_trip: float = 1.0):
    """``_batched_success``'s jitted chunk solve, returning every lane's
    record (the Reynolds number a closure constant, as there)."""
    @jax.jit
    def solve(batch):
        def one(coords):
            xp, yp = repanel(coords, jpb.N_PANELS)
            op = build_operator(panel_geometry(xp, yp))
            r = solve_viscous(op, jpb.BENCH_ALPHA, re,
                              x_forced_transition=x_trip, **SOLVE_SHAPE)
            ok = (jnp.isfinite(r.cl) & jnp.isfinite(r.cd)
                  & (jnp.abs(r.cl) < 2.5) & (r.cd > 1e-4) & (r.cd < 0.08)
                  & (r.sep_fraction < 0.5))
            return {"cl": r.cl, "cd": r.cd, "cm": r.cm,
                    "sep_fraction": r.sep_fraction,
                    "converged": r.converged,
                    "xtr_upper": r.upper.x_transition,
                    "xtr_lower": r.lower.x_transition, "plausible": ok}
        return jax.vmap(one)(batch)
    return solve


def solve_records(geometries, re: float, x_trip: float = 1.0,
                  limit: int | None = None) -> dict:
    """One list a field over the geometries (the first ``limit``)."""
    arr, _ok = resample(geometries)
    if limit is not None:
        arr = arr[:limit]
    solve = chunk_solver(re, x_trip)
    out = {f: [] for f in FIELDS}
    chunk = jpb.CHUNK
    for i in range(0, len(arr), chunk):
        part = arr[i:i + chunk]
        pad = chunk - len(part)
        if pad:
            part = np.concatenate([part, np.repeat(part[-1:], pad, 0)])
        rec = jax.device_get(solve(part))
        for f in FIELDS:
            vals = np.asarray(rec[f])[:chunk - pad]
            out[f] += [bool(v) if vals.dtype == bool else float(v)
                       for v in vals]
    return out


def csv_verdicts(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "benchmark_results.csv")) as fh:
        rows = list(csv.DictReader(fh))
    return {"names": [r["name"] for r in rows],
            "multi_element": [r["multi_element"] == "True" for r in rows],
            "raw": [r["raw_converged"] == "True" for r in rows],
            "parsed": [r["parsed_converged"] == "True" for r in rows]}


def run_member(files, re: float, work: str) -> tuple[dict, dict, dict]:
    """The reference's ``run_benchmark`` with its solve at ``re``: the
    summary, the final verdicts and each path's solver records."""
    records = []
    orig = jpb._batched_success

    def patched(geometries):
        rec = solve_records(geometries, re)
        _arr, ok = resample(geometries)
        records.append(rec)
        return [bool(p) and m for p, m in zip(rec["plausible"], ok)]

    jpb._batched_success = patched
    try:
        summary = jpb.run_benchmark(files, work, corpus="synthetic")
    finally:
        jpb._batched_success = orig
    return summary, csv_verdicts(work), dict(zip(PATHS, records))


def flip_rate(verdicts: list[dict]) -> dict:
    """Per member, the verdicts on which it differs from both others."""
    out = {}
    for i, k in enumerate(MEMBERS_K):
        others = [v for j, v in enumerate(verdicts) if j != i]
        out[str(k)] = sum(
            1 for path in PATHS for n in range(len(verdicts[i][path]))
            if all(verdicts[i][path][n] != o[path][n] for o in others))
    return out


def probe_rows(coords, re: float) -> dict:
    rows = {}
    for name in jprobe.STRATEGIES:
        r = jprobe._solve_with(coords, PROBE_ALPHA, re, **PROBE_PLANS[name])
        cl = float(r.cl)
        rows[name] = {"converged": bool(r.converged) and bool(np.isfinite(cl)),
                      "cl": cl, "cd": float(r.cd), "cm": float(r.cm),
                      "sep_fraction": float(r.sep_fraction)}
    return rows


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    doc = {"generated_by": "tests/make_torch_bench_goldens.py",
           "jax_version": jax.__version__,
           "corpus": {"generator": "generate_corpus", "n": N_FILES,
                      "seed": SEED},
           "reynolds": jpb.BENCH_REYNOLDS, "alpha": jpb.BENCH_ALPHA,
           "n_panels": jpb.N_PANELS, "chunk": jpb.CHUNK,
           "resample_points": RESAMPLE_POINTS, "solve_shape": SOLVE_SHAPE,
           "members_k": list(MEMBERS_K), "trip_x": TRIP_X}
    with tempfile.TemporaryDirectory() as tmp:
        files = generate_corpus(os.path.join(tmp, "corpus"), n=N_FILES,
                                seed=SEED)
        raw = [np.asarray(g) if len(g) >= 5 else None
               for g in map(jpb.raw_coords_from_file, files)]

        ref_dir = os.path.join(tmp, "reference")
        ref_summary = jpb.run_benchmark(files, ref_dir, corpus="synthetic")
        ref = csv_verdicts(ref_dir)
        print(f"reference {ref_summary} ({time.time() - t0:.0f} s)",
              flush=True)

        members, verdicts = {}, []
        for k in MEMBERS_K:
            work = os.path.join(tmp, f"k{k}")
            summary, final, recs = run_member(files, member_re(k), work)
            members[str(k)] = {"re": member_re(k), "summary": summary,
                               **{p: {**recs[p], "verdict": final[p]}
                                  for p in PATHS}}
            verdicts.append(final)
            print(f"k {k}: {summary} ({time.time() - t0:.0f} s)",
                  flush=True)
        nominal = verdicts[MEMBERS_K.index(0)]
        doc["names"] = ref["names"]
        doc["multi_element"] = ref["multi_element"]
        doc["reference"] = {
            "summary": ref_summary, "raw": ref["raw"],
            "parsed": ref["parsed"],
            "nominal_member_differs": sum(
                ref[p][n] != nominal[p][n] for p in PATHS
                for n in range(len(ref[p])))}
        doc["members"] = members
        rates = flip_rate(verdicts)
        doc["flip_rate"] = {"per_member": rates, "S": max(rates.values())}
        print(f"flip rate {doc['flip_rate']}", flush=True)

        parsed = []
        for path in files[:jpb.CHUNK]:
            try:
                parsed.append(np.asarray(parse_dat_file(path)[0]))
            except Exception:
                parsed.append(None)
        doc["tripped"] = {
            str(k): {"raw": solve_records(raw, member_re(k), TRIP_X,
                                          limit=jpb.CHUNK),
                     "parsed": solve_records(parsed, member_re(k), TRIP_X)}
            for k in MEMBERS_K}
        print(f"tripped ({time.time() - t0:.0f} s)", flush=True)

        probes = {"naca2412": np.asarray(naca4(2, 4, 12, 100)),
                  os.path.basename(files[1]):
                      np.asarray(parse_dat_file(files[1])[0])}
        doc["probe"] = {name: {str(k): probe_rows(coords, member_re(k))
                               for k in MEMBERS_K}
                        for name, coords in probes.items()}
        print(f"probe ({time.time() - t0:.0f} s)", flush=True)

    doc["seconds"] = round(time.time() - t0, 1)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.write("\n")
    print(f"wrote {OUT} in {doc['seconds']} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
