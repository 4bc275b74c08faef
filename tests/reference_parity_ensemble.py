"""The JAX reference's own rounding ensemble at the parity anchors of NACA
2412 at Re 1e6 (the group whose stall tail the reference leaves
unconverged): the harness's product-path polar (a 0.5-degree grid
from -2 degrees holding every anchor alpha, ``airfoil_tpu/bench/parity.py``)
at Re (1 + k 2^-23) for k in ``ENSEMBLE_K``, on the CPU. Where the port's
verdict at an anchor differs from the committed reference report's, this
shows whether the reference's own verdict there turns on rounding.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/reference_parity_ensemble.py \\
        [--out ensemble.json]

Writes {"airfoil", "reynolds", "members": [{"k", "points": [{"alpha",
"cl", "cd", "converged"}]}]}, rewritten after every member (~6 min a
member on an otherwise idle 8-core CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

ENSEMBLE_K = (0, -1, 1)
AIRFOIL = "naca2412"
RE = 1e6


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    from airfoil_tpu.bench import parity

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="reference_parity_ensemble.json")
    args = ap.parse_args()
    alphas = sorted(a for (name, re_, a) in parity.load_truth()
                    if name == AIRFOIL and re_ == RE)
    doc = {"airfoil": AIRFOIL, "reynolds": RE,
           "jax_version": jax.__version__, "members": []}
    re32 = np.float32(RE)
    for k in ENSEMBLE_K:
        t0 = time.perf_counter()
        re_k = float(re32 * (1.0 + k * 2.0 ** -23))
        out = parity._solve_polar_points(AIRFOIL, re_k, alphas)
        doc["members"].append({"k": k, "reynolds": re_k,
                               "seconds": time.perf_counter() - t0,
                               "points": [{"alpha": a, "cl": out[a][0],
                                           "cd": out[a][1],
                                           "converged": out[a][2]}
                                          for a in alphas]})
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(json.dumps(doc["members"][-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
