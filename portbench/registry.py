"""Find the benchmark's parts by name: ``BENCHMARK.json`` at the checkout's
root, and under ``portbench/`` one file a cell, configuration, traffic mix
and metric."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(kind: str, name: str, base: str = HERE) -> dict:
    """``<base>/<kind>/<name>.json``."""
    with open(os.path.join(base, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = HERE):
    """``<base>/<kind>/<name>.py`` as a module of its own (a name may hold
    dots and dashes, so it is loaded by its path)."""
    path = os.path.join(base, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = "portbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str, base: str = HERE) -> dict:
    """The ``workloads`` entry of ``name`` merged with its cell file, and
    its configuration's and traffic mix's files under ``config_file`` and
    ``mix``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    spec = dict(load_json("workloads", name, base), **entry)
    spec["config_file"] = load_json("configs", entry["config"], base)
    spec["mix"] = load_json("traffic", entry["traffic"], base)
    return spec


def metrics_for(bench: dict, section: str, name: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``name`` reports: those that list it, or list no cells."""
    return [m for m in bench[section]
            if name in m.get("workloads", [name])]
