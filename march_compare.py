"""The march kernels of this checkout against an older source of them, on one
GPU: ``python3 march_compare.py OLD_CSRC``.

``OLD_CSRC`` is a directory holding an older ``bl_march.cu`` and
``bl_closures.cuh`` with the same C interface, for example the parent
commit's::

    mkdir -p scratch/old && git archive HEAD~1 airfoil_tpu_torch/csrc \\
        | tar -x -C scratch/old --strip-components=2
    python3 march_compare.py scratch/old

1. build — both sources, one nvcc each, in parallel, with the wrapper's
   flags; ptxas's registers, stack frames and spills of each kernel;
2. bits  — every march call of ``chip_smoke.py``'s march phase goes through
   the old and the new kernel, and the outputs must be equal bit for bit
   (NaNs included);
3. speed — each build in turns (old, new, new, old): the side kernel at 80
   stations (CUDA events, mean of 50) on the NACA 2412 alpha-5 side pair,
   its upper and lower side alone, a 31-point polar's 62 lanes and the
   first 132 to 1,914 lanes of the march phase's batch; the wake kernel on
   a default solve's last 24-station wake. Then the default
   ``solve_viscous`` (NACA 2412, alpha 5, Re 1e6; synchronised wall time)
   in 30 rounds of one solve with each build, old first in even rounds and
   new first in odd ones, so that both see the same host: each build's
   median and range, and the median of the rounds' differences.

Prints the card's name and power limit first; exits non-zero if a build
fails or the two kernels differ.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from airfoil_tpu_torch import cuda_build

OUT = os.path.join(cs.ROOT, "airfoil_tpu_torch", "_build", "march_compare")
LANES = (132, 264, 528, 792, 1056)
N_ROUNDS = 30


def build(name: str, csrc: str, flags) -> tuple:
    """Builds ``csrc``'s march library as ``name``; (library, ptxas usage)."""
    d = os.path.join(OUT, name)
    shutil.copytree(csrc, d, ignore=shutil.ignore_patterns("*.so", "*.o"))
    so = os.path.join(d, "libbl_march.so")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           *flags, "-o", so, os.path.join(d, "bl_march.cu")],
                          capture_output=True, text=True)
    cs.require(proc.returncode == 0, f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bl_march_side_launch.argtypes = [ptr] * 15 + [i32, i32, i32, ptr]
    lib.bl_march_wake_launch.argtypes = [ptr] * 9 + [i32, i32, i32, ptr]
    lib.bl_error_string.argtypes = [i32]
    lib.bl_error_string.restype = ctypes.c_char_p
    return lib, cs.ptxas_usage(proc.stderr)


def wall_s(fn) -> float:
    """Synchronised wall seconds of one call of ``fn``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(old_dir: str) -> int:
    if not torch.cuda.is_available():
        print("march_compare: no CUDA device", file=sys.stderr)
        return 1
    from airfoil_tpu_torch import inviscid, paneling
    from airfoil_tpu_torch.viscous import coupled, march
    from airfoil_tpu_torch.viscous import kernel as mk

    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"[device] {card}")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    sources = {"old": old_dir, "new": cuda_build.CSRC_DIR}
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {n: pool.submit(build, n, d, mk._FLAGS)
                for n, d in sources.items()}
        built = {n: f.result() for n, f in futs.items()}
    for name, (_, use) in built.items():
        cs.log(f"[build] {name}: ptxas {json.dumps(use)}")
    libs = {n: b[0] for n, b in built.items()}
    load = mk.load

    @contextlib.contextmanager
    def using(name):
        mk.load = lambda: libs[name]
        try:
            yield
        finally:
            mk.load = load

    # Every march call of chip_smoke's march phase, old against new.
    stats = {"side calls": 0, "side lanes": 0, "wake calls": 0,
             "wake lanes": 0}
    originals = {"march_side": mk.march_side, "march_wake": mk.march_wake}

    def both(name):
        def run(*args):
            with using("new"):
                new = originals[name](*args)
            with using("old"):
                old = originals[name](*args)
            cs.require(cs._same_bits(new, old),
                       f"{name}: new and old kernels differ")
            kind = "side" if name == "march_side" else "wake"
            stats[f"{kind} calls"] += 1
            stats[f"{kind} lanes"] += new[0].reshape(-1, new[0].shape[-1]).shape[0]
            return new
        return run

    goldens = cs.load_goldens()
    op = cs.naca_operator("2412", dev, paneling, inviscid)
    for name in originals:
        setattr(mk, name, both(name))
    try:
        _, sides, batch = cs.phase_march(dev, mk, march, coupled, inviscid,
                                         op, goldens["trip_x"])
    finally:
        for name, fn in originals.items():
            setattr(mk, name, fn)
    cs.log(f"[bits] chip_smoke's march phase through both kernels: "
           f"{json.dumps(stats)}, every output bit-identical")

    polar = cs._airfoil_sides(op, coupled, inviscid, cs.POLAR_ALPHAS)
    with cs.recording(mk) as calls, using("new"):
        coupled.solve_viscous(op, 5.0, 1e6)
    wake = calls["march_wake"][-1]
    s, ue, x = sides
    cases = {"side pair": [s[2:], ue[2:], x[2:], 1e-6],
             "upper side": [s[2:3], ue[2:3], x[2:3], 1e-6],
             "lower side": [s[3:], ue[3:], x[3:], 1e-6],
             "polar, 62 lanes": polar + [1e-6]}
    for n in LANES + (batch[0].shape[0],):
        cases[f"batch, {n} lanes"] = [a[:n] for a in batch]
    cases = {k: [a.contiguous() if torch.is_tensor(a) else a for a in v]
             for k, v in cases.items()}

    times = {}
    for name in ("old", "new", "new", "old"):
        with using(name):
            for case, args in cases.items():
                times.setdefault((name, case), []).append(
                    cs.cuda_ms(lambda: mk.march_side(*args), 50))
            times.setdefault((name, "wake"), []).append(
                cs.cuda_ms(lambda: mk.march_wake(*wake), 50))
    for name in libs:
        cs.log(f"[speed] {name}: " + "; ".join(
            f"{case} {', '.join(f'{t:.4f}' for t in times[(name, case)])} ms"
            for case in [*cases, "wake"]) + f" ({card})")

    solve = lambda: coupled.solve_viscous(op, 5.0, 1e6)
    solves = {name: [] for name in libs}
    for name in libs:                                  # warm
        with using(name):
            solve()
    for r in range(N_ROUNDS):
        for name in (("old", "new") if r % 2 == 0 else ("new", "old")):
            with using(name):
                solves[name].append(wall_s(solve) * 1e3)
    for name, t in solves.items():
        cs.log(f"[speed] {name}: default solve_viscous, {N_ROUNDS} solves: "
               f"median {statistics.median(t):.3f} ms, range "
               f"{min(t):.3f}-{max(t):.3f} ms ({card})")
    diff = [a - b for a, b in zip(solves["old"], solves["new"])]
    cs.log(f"[speed] default solve_viscous, old - new in each of "
           f"{N_ROUNDS} rounds: median {statistics.median(diff):.3f} ms, "
           f"range {min(diff):.3f} to {max(diff):.3f} ms ({card})")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
