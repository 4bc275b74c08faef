"""The solvers of this checkout against an older tree of the port, on one
GPU: ``python3 graph_compare.py OLD_TREE [OUT_JSON]``.

``OLD_TREE`` is a directory holding an older ``airfoil_tpu_torch`` package,
for example the parent commit's::

    mkdir -p scratch/parent && git archive HEAD~1 airfoil_tpu_torch \\
        | tar -x -C scratch/parent
    python3 graph_compare.py scratch/parent

Each tree runs in a child process of its own (the tree first on
``sys.path``, its kernel libraries built into its own ``_build``), in
turns: old, new, new, old. A child measures, through functions that both
trees have:

1. one LM iteration, ``system.run_lm(zz, lam, 1)`` after one warm call (a
   graph replay with its copies where the tree has ``viscous.graphs``,
   eager dispatch where it does not), at 1 lane (NACA 2412, alpha 4, Re
   1e6, 160 panels, 96 stations) and 32 (alpha -2..6): median of 5,
   synchronised;
2. the default ``solve_viscous_newton`` at that point: one warm solve,
   then the median of 3;
3. the golden polar (NACA 2412, 80 points a side, alpha -2..6 step 2, Re
   1e6) and the headline's polar (100 points a side, alpha -10..20 step 1):
   each once, after ``warm_polar_kernels`` of its bucket where the tree
   has it (as ``bench.py`` warms before it times); the polar's modes;
4. the default direct solve ``solve_viscous`` at that point (one lane,
   160 panels, 80/24/24): one warm solve, then the median of 10, and its
   CL, CD and ``converged``;
5. the graft entry's ``fn`` (``graft_entry.entry()``: repanel to 128
   panels, the operator, the direct solve at 48/16/12): one warm call, then
   the median of 10, and its [cl, cd, cm];
6. the parser benchmark (``bench.parser_benchmark.run_benchmark``) over
   the 500-file synthetic corpus (seed 0), once, as its CLI runs it (the
   first chunk captures the tree's graphs where it has them): its wall,
   split into the chunks' operator builds (``chunk_operators``), their
   lane solves (``solve_chunk``), each timed synchronised, and the rest on
   the host (corpus parse, resample, CSV); and its raw, parsed, rescued
   and regressed counts;
7. the headline polar once more, with its walk (``sweep._walk``) and the
   walk's continuation solves (``sweep.solve_polar_point_cont``) timed
   synchronised: the walk's host bookkeeping outside its solves (the walk
   less its solves) as a share of that polar's wall;
8. the served frame at 384x192 (NACA 2412, alpha 6): ``WindTunnel.frame``
   (the LBM step and the frame diagnostics, three scalars read back) after
   10 warm frames, the median of 50; the same at 2048x1024; and the
   ``/lbm/frame`` round trip (speed, cp and vorticity as base64 in the
   JSON) through a server on a local port, the median of 40 after 10.

Prints the card's name and power limit first, then one JSON line a child
run, then the medians of each tree; writes them all to ``OUT_JSON`` where
it is given. Exits non-zero if a child fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POINT = ("2412", 4.0, 1e6)
POLARS = {"golden": ((2, 4, 12, 80), [-2.0, 0.0, 2.0, 4.0, 6.0]),
          "headline": ((2, 4, 12, 100), [float(a) for a in range(-10, 21)])}


def _wall(fn, n: int) -> float:
    import torch
    t = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return statistics.median(t)


def _timed(acc: dict, key: str, fn):
    """``fn``, its synchronised wall added to ``acc[key]`` at each call."""
    import torch

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
    return run


def child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import airfoil_tpu_torch
    from airfoil_tpu_torch.inviscid import build_operator
    from airfoil_tpu_torch.models import naca4
    from airfoil_tpu_torch.paneling import panel_geometry, repanel
    from airfoil_tpu_torch.polar import sweep
    from airfoil_tpu_torch.viscous import kernel, newton

    pkg = os.path.dirname(os.path.abspath(airfoil_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise RuntimeError(f"airfoil_tpu_torch from {pkg}, not {tree}")
    try:
        from airfoil_tpu_torch.viscous import graphs
    except ImportError:
        graphs = None
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernel.load()
    out = {"tree": tree, "graphs": graphs is not None,
           "build_s": time.perf_counter() - t0}
    code, alpha, re = POINT
    op = build_operator(panel_geometry(*repanel(
        naca4(int(code[0]), int(code[1]), int(code[2:]), 100), 160,
        device=dev)))
    for p in (1, 32):
        a = (torch.tensor(np.linspace(-2.0, 6.0, p), dtype=torch.float32,
                          device=dev) if p > 1 else alpha)
        system, _sc, _ws, zz = newton._prepare(op, a, re, 9.0, 1.0, 96, 20,
                                               8)
        lam = torch.full((zz.shape[0],), 1e-3, device=dev)
        system.run_lm(zz, lam, 1)
        out[f"lm_iteration_ms_{p}"] = _wall(
            lambda: system.run_lm(zz, lam, 1), 5) * 1e3
        del system, zz, lam
    newton.solve_viscous_newton(op, alpha, re)
    out["solve_viscous_newton_ms"] = _wall(
        lambda: newton.solve_viscous_newton(op, alpha, re), 3) * 1e3
    for name, (naca, alphas) in POLARS.items():
        if graphs is not None:
            t0 = time.perf_counter()
            sweep.warm_polar_kernels(p=len(alphas), device=dev)
            out[f"{name}_warm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sweep.solve_polar(np.asarray(naca4(*naca), np.float32), alphas,
                                1e6, device=dev)
        out[f"{name}_polar_s"] = time.perf_counter() - t0
        out[f"{name}_modes"] = np.asarray(res.mode).tolist()

    from airfoil_tpu_torch import graft_entry
    from airfoil_tpu_torch.bench import corpus, parser_benchmark
    from airfoil_tpu_torch.viscous import coupled

    r = coupled.solve_viscous(op, alpha, re)
    out["solve_viscous_ms"] = _wall(
        lambda: coupled.solve_viscous(op, alpha, re), 10) * 1e3
    out["solve_viscous_result"] = [float(r.cl), float(r.cd),
                                   bool(r.converged)]
    fn, args = graft_entry.entry(dev)
    out["graft_entry_result"] = fn(*args).tolist()
    out["graft_entry_ms"] = _wall(lambda: fn(*args), 10) * 1e3
    split = {"operators": 0.0, "solves": 0.0}
    orig_ops = parser_benchmark.chunk_operators
    orig_solve = parser_benchmark.solve_chunk
    parser_benchmark.chunk_operators = _timed(split, "operators", orig_ops)
    parser_benchmark.solve_chunk = _timed(split, "solves", orig_solve)
    try:
        with tempfile.TemporaryDirectory() as work:
            files = corpus.generate_corpus(os.path.join(work, "corpus"),
                                           n=500, seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = parser_benchmark.run_benchmark(
                files, os.path.join(work, "out"), device=dev)
            torch.cuda.synchronize()
            out["parser_benchmark_s"] = time.perf_counter() - t0
    finally:
        parser_benchmark.chunk_operators = orig_ops
        parser_benchmark.solve_chunk = orig_solve
    out["parser_benchmark_counts"] = [summary[k] for k in (
        "raw_converged", "parsed_converged", "rescued", "regressed")]
    out.update({f"parser_{k}_s": v for k, v in split.items()})
    out["parser_host_s"] = out["parser_benchmark_s"] - sum(split.values())

    # The headline polar again, its walk split from the walk's solves.
    walk = {"walk": 0.0, "solves": 0.0}
    orig_walk, orig_cont = sweep._walk, sweep.solve_polar_point_cont
    sweep._walk = _timed(walk, "walk", orig_walk)
    sweep.solve_polar_point_cont = _timed(walk, "solves", orig_cont)
    naca, alphas = POLARS["headline"]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep.solve_polar(np.asarray(naca4(*naca), np.float32), alphas, 1e6,
                          device=dev)
        torch.cuda.synchronize()
        polar_s = time.perf_counter() - t0
    finally:
        sweep._walk, sweep.solve_polar_point_cont = orig_walk, orig_cont
    out["headline_instrumented_polar_s"] = polar_s
    out["headline_walk_s"] = walk["walk"]
    out["headline_walk_solves_s"] = walk["solves"]
    out["headline_walk_host_share"] = (walk["walk"] - walk["solves"]) / polar_s

    # The served frame.
    from airfoil_tpu_torch.api.minihttp import make_server
    from airfoil_tpu_torch.config import LBMConfig
    from airfoil_tpu_torch.lbm.runner import WindTunnel
    from chip_smoke import _post, naca4_coords
    for nx, ny in ((384, 192), (2048, 1024)):
        wt = WindTunnel(naca4_coords(), cfg=LBMConfig(nx=nx, ny=ny),
                        device=dev)
        for _ in range(10):
            wt.frame()
        out[f"frame_ms_{nx}x{ny}"] = _wall(wt.frame, 50) * 1e3
        del wt
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device=dev)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                     for x, y in naca4_coords())
    try:
        status, meta = _post(url + "/lbm/start", {"alpha": 6.0},
                             {"file": ("naca2412.dat", dat.encode())})
        if status != 200:
            raise RuntimeError(f"/lbm/start -> {status} {meta}")
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            status, _fr = _post(url + "/lbm/frame",
                                {"session": meta["session"],
                                 "fields": "speed,cp,vorticity"})
            lat.append(time.perf_counter() - t0)
            if status != 200:
                raise RuntimeError(f"/lbm/frame -> {status}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    out["lbm_frame_round_trip_ms"] = statistics.median(lat[10:]) * 1e3
    if graphs is not None:
        keys = list(graphs.captures)
        if hasattr(graphs, "total"):      # keyed by (program, key)
            out["captures"] = {prog: graphs.total(graphs.captures, prog)
                               for prog in sorted({k[0] for k in keys})}
            out["replays"] = {prog: graphs.total(graphs.replays, prog)
                              for prog in sorted({k[0] for k in keys})}
            out["pool_bytes"] = {f"{k[0]} {k[1][1:]}": v
                                 for k, v in graphs.pool_bytes.items()}
        else:
            out["captures"] = sum(graphs.captures.values())
            out["replays"] = sum(graphs.replays.values())
            out["pool_bytes"] = {str(k[1:]): v
                                 for k, v in graphs.pool_bytes.items()}
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(argv[2])), flush=True)
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old = os.path.abspath(argv[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in (old, ROOT, ROOT, old):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], cwd=ROOT,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = [k for k, v in runs[0].items()
            if isinstance(v, float) and not k.endswith("_warm_s")]
    summary = {which: {k: statistics.median(r[k] for r in runs
                                             if r["tree"] == tree)
                       for k in keys}
               for which, tree in (("old", old), ("new", ROOT))}
    print(json.dumps(summary), flush=True)
    if len(argv) == 3:
        with open(argv[2], "w") as f:
            json.dump({"card": card, "runs": runs, "medians": summary}, f,
                      indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
