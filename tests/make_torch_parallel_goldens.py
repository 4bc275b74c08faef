"""Write ``tests/golden/torch_parallel.json``: reference outputs of the JAX
package's sharded polar and of its graft entry, for the checks of
``airfoil_tpu_torch.parallel`` and ``airfoil_tpu_torch.graft_entry`` that
run where JAX is not installed (``chip_smoke.py`` on the GPU machine).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_parallel_goldens.py

Runs the JAX package on the CPU with 4 virtual devices (~15 min; it
rewrites the file after every section). The file holds:

- ``polar``: ``sharded_polar(batch_mesh(devices[:n]), naca4(2, 4, 12, 80),
  [-2, 0, 2, 4, 6], 1e6)`` at the reference's full width (160 panels, 96
  stations a side, 20 wake stations) on meshes of n = 1 and n = 4 devices
  (``meshes``, keyed by n). Each point carries a rounding ensemble of 9
  members, the run at Re (1 + k 2^-23) for k in ``ENSEMBLE_K`` (the nominal
  run, k = 0, first), as every member's record (``members``) and the range
  of each output (``ensemble``): which transition basin a Newton solve
  lands in turns on float32 rounding, so a check holds a port's point
  jointly to one member with its ``mode`` and ``converged``. Each mesh
  also keeps the nominal run's per-point pass shard by shard (``blocks``:
  the sharded points kernel's answer of every padded lane of each device's
  block, with its final state ``zz``, ``xtr_u``, ``xtr_l``): a lane-batched
  solve of a block started from those states must return those answers.
- ``entry``: ``__graft_entry__.entry()``'s ``[cl, cd, cm]`` (NACA 2412,
  60 points a side, 128 panels, 48 stations, 16 wake stations, 12
  coupling passes, alpha 5), jitted, over the same 9 members.
"""

from __future__ import annotations

import json
import os
import sys
import time

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_parallel.json")
RE = 1e6
POLAR_NACA = (2, 4, 12, 80)
POLAR_ALPHAS = [-2.0, 0.0, 2.0, 4.0, 6.0]
MESHES = (1, 4)
ENSEMBLE_K = [0, -4, -3, -2, -1, 1, 2, 3, 4]
FIELDS = ("cl", "cd", "cdp", "cm", "xtr_upper", "xtr_lower", "sep_fraction")
MERGED = FIELDS[:4] + ("converged",) + FIELDS[4:]
OUTPUTS = ("cl", "cd", "cdp", "cm", "mode", "converged", "xtr_upper",
           "xtr_lower", "sep_fraction")


def member_re(k: int) -> float:
    re32 = np.float32(RE)
    return float(re32 * (1.0 + k * 2.0 ** -23))


def summarise(members: list, flags=("converged", "mode")) -> dict:
    rec = dict(members[0])
    rec["ensemble"] = {f: [min(m[f] for m in members),
                           max(m[f] for m in members)]
                       for f in members[0] if f not in flags + ("alpha",)}
    for flag in flags:
        rec["ensemble"][flag] = sorted({m[flag] for m in members})
    rec["members"] = members
    return rec


def polar_records(out, alphas) -> list:
    recs = []
    for i, a in enumerate(alphas):
        rec = {"alpha": float(a)}
        for f, v in zip(OUTPUTS, out):
            v = np.asarray(v)[i]
            rec[f] = (int(v) if f == "mode" else bool(v) if f == "converged"
                      else float(v))
        recs.append(rec)
    return recs


def block_records(mesh, coords, alphas) -> list:
    """The nominal run's per-point pass, as the sharded points kernel
    computes it, split into each device's block."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from airfoil_tpu.parallel import mesh as M

    a_sh, re_sh, _pad, _unsort = M.shard_polar_inputs(mesh, alphas, RE)
    op, _xp, _yp = M._op_kernel(jax.device_put(
        jnp.asarray(coords), NamedSharding(mesh, P())), 160)
    merged, (nok, (zz, xtr_u, xtr_l)) = M._sharded_points_kernel(
        op, a_sh, re_sh, mesh)
    a = np.asarray(a_sh)
    merged = [np.asarray(v) for v in merged]
    nok, zz = np.asarray(nok), np.asarray(zz)
    xtr_u, xtr_l = np.asarray(xtr_u), np.asarray(xtr_l)
    recs = []
    for i in range(len(a)):
        rec = {f: (bool(v[i]) if f == "converged" else float(v[i]))
               for f, v in zip(MERGED, merged)}
        rec["alpha"] = float(a[i])
        rec["newton_converged"] = bool(nok[i])
        rec["state"] = {"zz": [float(v) for v in zz[i]],
                        "xtr_u": float(xtr_u[i]), "xtr_l": float(xtr_l[i])}
        recs.append(rec)
    n = mesh.devices.size
    rows = len(recs) // n
    return [recs[d * rows:(d + 1) * rows] for d in range(n)]


def polar_section(log) -> dict:
    from airfoil_tpu.models import naca4
    from airfoil_tpu.parallel import batch_mesh, sharded_polar

    coords = np.asarray(naca4(*POLAR_NACA), np.float32)
    alphas = np.asarray(POLAR_ALPHAS, np.float32)
    meshes = {}
    for n in MESHES:
        mesh = batch_mesh(jax.devices()[:n])
        runs = []
        for k in ENSEMBLE_K:
            runs.append(polar_records(
                sharded_polar(mesh, coords, alphas, member_re(k)), alphas))
            log(f"mesh {n}, k {k}: modes {[r['mode'] for r in runs[-1]]} "
                f"cd {[round(r['cd'], 5) for r in runs[-1]]}")
        meshes[str(n)] = {
            "points": [summarise([run[i] for run in runs])
                       for i in range(len(alphas))],
            "blocks": block_records(mesh, coords, alphas)}
    return {"naca": list(POLAR_NACA), "alphas": POLAR_ALPHAS, "re": RE,
            "n_panels": 160, "meshes": meshes}


def entry_section(log) -> dict:
    import jax.numpy as jnp

    import __graft_entry__ as graft

    fn, (coords, alpha, _re) = graft.entry()
    jitted = jax.jit(fn)
    members = []
    for k in ENSEMBLE_K:
        out = np.asarray(jitted(coords, alpha, jnp.float32(member_re(k))))
        members.append({"cl": float(out[0]), "cd": float(out[1]),
                        "cm": float(out[2])})
        log(f"entry k {k}: {members[-1]}")
    return {"naca": [2, 4, 12, 60], "alpha": 5.0, "re": RE, "n_panels": 128,
            "n_stations": 48, "n_wake": 16, "coupling_iters": 12,
            **summarise(members, flags=())}


def write(doc: dict) -> None:
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    doc = {"generated_by": "tests/make_torch_parallel_goldens.py",
           "jax_version": jax.__version__,
           "geometry": "airfoil_tpu.models.naca4(m, p, t, n)",
           "ensemble_k": ENSEMBLE_K,
           "ensemble": "Re (1 + k 2^-23), the nominal run (k = 0) first"}

    def log(msg):
        print(f"[{time.perf_counter() - t0:7.1f} s] {msg}", flush=True)

    doc["entry"] = entry_section(log)
    write(doc)
    doc["polar"] = polar_section(log)
    write(doc)
    log(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
