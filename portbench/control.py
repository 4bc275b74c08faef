"""The control of a cell's comparison: the configuration's plain reference,
put in the program's place and computed in the configuration's
``control_precision`` (the precision next below the one it states), judged
by the same comparison as a run. A sound comparison rejects it.

    python3 portbench/control.py --workload NAME --seeds 1 2 3 --frames N

For each seed, each client's first ``N`` window requests of the cell's
traffic are served by the reference in the control precision (``--dtype``
names another), with the bulky parts of a seeded sample of them (the cell's
``sample.size``) and of the last; one JSON line a seed gives each number's
reading beside its limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import registry, traffic  # noqa: E402


def control(name: str, seed: int, frames: int, device, dtype=None) -> dict:
    """{number: {"value", "limit"}} of the control on ``seed``."""
    import torch

    spec = registry.cell(registry.benchmark(), name)
    cfg = spec["config_file"]
    dtype = dtype or getattr(torch, cfg["control_precision"])
    plan = traffic.plan(spec["mix"], seed)
    reference = registry.load_module("configs", spec["config"])
    clients = []
    for k, client in enumerate(plan.clients):
        requests = list(itertools.islice(client.window, frames))
        keep = set(random.Random(seed * 1_000_003 + k).sample(
            range(frames), min(spec["sample"]["size"], frames))) \
            | {frames - 1}
        setup = [SimpleNamespace(route=r.route, fields=r.fields,
                                 files=r.files) for r in client.setup]
        clients.append(SimpleNamespace(setup=setup, window=reference.served(
            setup, requests, keep, cfg, device, dtype)))
    readings = reference.numbers(clients, cfg, device)
    return {k: {"value": v, "limit": cfg["limits"][k]}
            for k, v in readings.items()}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--dtype", default=None,
                   help="serve in this dtype instead (a witness: float32)")
    args = p.parse_args(argv)
    dtype = getattr(torch, args.dtype) if args.dtype else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control(args.workload, seed, args.frames,
                         torch.device("cuda"), dtype)
        rejected = any(c["value"] > c["limit"] for c in checks.values())
        print(json.dumps({"seed": seed, "frames": args.frames,
                          "dtype": args.dtype or "control",
                          "rejected": rejected, "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
