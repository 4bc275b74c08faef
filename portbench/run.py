"""Run one cell of the benchmark of ``airfoil_tpu_torch`` and print its
result as the last line of standard output.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell's service runs in a thread of this process: the port's minihttp
server on the card, rate limiter off, serving the handlers that the
FastAPI transport serves too. The cell's traffic mix says who drives it:
closed-loop clients, each on a keep-alive connection of its own, or
arrivals on a schedule sent over a few connections. Set-up (the host
settings of the configuration, the kernels' builds and graph captures, the
mix's warm-up on the cell's own shapes and each client's set-up requests)
ends before the window opens; requests start while the window is open, and
it closes when the last of them answers. With ``--trace 1`` the cell's
per-layer metrics are read instead of its end-to-end ones: spans around the
calls the cell names, the program's counters, and a ``torch.profiler``
trace of a slice of the window. Then the program is stopped and freed, and
the configuration's plain reference follows the run and decides
``correct``: each number it compares is printed beside its limit, on
standard error and under ``checks`` in the result.

Exits 2 without a CUDA card (or with fewer than the cell asks for) and 4
if JAX or the JAX package was loaded; neither prints a result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import importlib
import json
import os
import queue
import random
import re
import statistics
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import registry  # noqa: E402
from portbench.client import Client  # noqa: E402
from portbench.stats import percentile, window_bounds  # noqa: E402
from portbench.trace import MARK  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "airfoil_tpu")
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3       # glibc's mallopt


def process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (from ``/proc``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def apply_host(host: dict):
    """The configuration's host settings, before numpy and torch start
    their threads: ``cores`` (the process keeps the machine's last that
    many), ``math_threads`` (OpenMP, MKL and OpenBLAS threads) and
    ``malloc`` (glibc's ``mmap_threshold`` and ``trim_threshold``, in
    bytes; setting them turns glibc's moving thresholds off)."""
    if "math_threads" in host:
        n = str(host["math_threads"])
        os.environ.update(OMP_NUM_THREADS=n, MKL_NUM_THREADS=n,
                          OPENBLAS_NUM_THREADS=n)
    if "cores" in host and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(
            0, sorted(os.sched_getaffinity(0))[-host["cores"]:])
    malloc = host.get("malloc", {})
    if malloc:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt.restype = ctypes.c_int
        for param, key in ((M_MMAP_THRESHOLD, "mmap_threshold"),
                           (M_TRIM_THRESHOLD, "trim_threshold")):
            if key in malloc and not libc.mallopt(param, malloc[key]):
                raise OSError(f"mallopt refused {key}={malloc[key]}")


def set_environment():
    """What the service writes goes under the temporary directory; no
    library may load JAX."""
    base = os.path.join(tempfile.gettempdir(), "portbench")
    os.makedirs(base, exist_ok=True)
    os.environ["AIRFOIL_TPU_RUN_LOG_DIR"] = os.path.join(base, "runs")
    os.environ["AIRFOIL_TPU_STATS_PATH"] = os.path.join(base, "stats.db")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class Record:
    client: int
    route: str
    fields: dict
    files: dict
    status: int
    sent: float            # the request's bytes sent; open loop: its arrival
    received: float        # the reply's last byte read
    reply: dict | None

    @property
    def seconds(self) -> float:
        return self.received - self.sent


def send(conn: Client, req, bound: dict, client: int = 0,
         annotate: bool = False, arrived: float | None = None) -> Record:
    """Send ``req`` with the names in braces filled from ``bound``; the
    reply's JSON is parsed after the round trip's stamp. ``annotate`` marks
    both in a profiler's trace. An open loop's request counts from its
    ``arrived`` time, its wait for a connection included."""
    fields = {k: re.sub(r"\{(\w+)\}", lambda m: str(bound[m.group(1)]), v)
              for k, v in req.fields.items()}
    with _mark(annotate, f"client round trip {req.route}"):
        r = conn.post(req.route, fields, req.files)
    reply = None
    if r.status == 200:
        try:
            with _mark(annotate, "client json.loads"):
                reply = json.loads(r.body)
        except ValueError:
            reply = None
    for key in req.bind:
        if reply is not None:
            bound[key] = reply[key]
    return Record(client, req.route, fields, req.files, r.status,
                  r.sent if arrived is None else arrived, r.received, reply)


def _mark(on: bool, label: str):
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.autograd.profiler.record_function(MARK + label)


def resolve(path: str):
    """``module:attr.attr`` -> (owner object, attribute name)."""
    mod, _, attrs = path.partition(":")
    owner = importlib.import_module(mod)
    *parents, name = attrs.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


def counter_values(spec: dict) -> dict:
    """Each named counter now: a number, or the sum of a dict's values."""
    out = {}
    for label, path in spec.items():
        owner, name = resolve(path)
        v = getattr(owner, name)
        out[label] = sum(v.values()) if isinstance(v, dict) else v
    return out


class Spans:
    """Host-clock spans around the calls a cell names, while installed."""

    def __init__(self, spec: dict):
        self.spec, self.saved = spec, []
        self.spans = {label: [] for label in spec}

    def install(self):
        for label, path in self.spec.items():
            owner, name = resolve(path)
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, self.spans[label], label))

    @staticmethod
    def _wrap(fn, out, label):
        import torch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.autograd.profiler.record_function(MARK + label):
                    return fn(*args, **kwargs)
            finally:
                out.append((t0, time.perf_counter()))
        return timed

    def remove(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


def serve(device):
    from airfoil_tpu_torch.api import minihttp

    httpd = minihttp.make_server("127.0.0.1", 0, rate_limit=False,
                                 device=device)
    thread = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05},
                              name="portbench-server")
    thread.start()
    return httpd, thread


class Keeper:
    """Keeps a client's replies for the reference, compactly, so that the
    client's own garbage does not slow the collector: their lists named in
    ``sample.arrays`` as numpy arrays, and their bulky parts
    (``sample.drop``) only for a seeded sample of them and for the last."""

    def __init__(self, sample: dict, seed: int):
        self.sample, self.rng = sample, random.Random(seed)
        self.kept: set[int] = set()

    def add(self, records: list):
        import numpy as np

        sample = self.sample
        i = len(records) - 1
        reply = records[i].reply
        for key in sample.get("arrays", ()) if reply is not None else ():
            reply[key] = np.asarray(reply[key], np.float64)
        evicted = None
        if len(self.kept) < sample.get("size", 0):
            self.kept.add(i)
        else:
            j = self.rng.randrange(i + 1)
            if j < sample.get("size", 0):
                evicted = sorted(self.kept)[j]
                self.kept.discard(evicted)
                self.kept.add(i)
        for k in (i - 1, evicted):
            if k is not None and k >= 0 and k not in self.kept \
                    and records[k].reply is not None:
                for key in sample.get("drop", ()):
                    records[k].reply.pop(key, None)


def closed_loop(conns, traffic, bounds, spec, seconds, seed, prof):
    """Each client sends its next request as soon as its last one has
    answered, while the window is open; the first client, in this thread,
    also moves the profiler. Returns each client's records in order."""
    out = [[] for _ in conns]
    errors = []
    t_open = time.perf_counter()

    def client(k):
        keeper = Keeper(spec["sample"], seed * 1_000_003 + k)
        try:
            for req in traffic.clients[k].window:
                now = time.perf_counter()
                if now - t_open >= seconds:
                    break
                if k == 0 and prof is not None:
                    prof.tick(now - t_open)
                out[k].append(send(conns[k], req, bounds[k], k,
                                   prof is not None))
                keeper.add(out[k])
        except Exception as e:      # noqa: BLE001 (raised below)
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"portbench-client-{k}")
               for k in range(1, len(conns))]
    for t in threads:
        t.start()
    client(0)
    for t in threads:
        t.join()
    if prof is not None:
        prof.finish()
    if errors:
        raise errors[0]
    return out


def open_loop(conns, traffic, bounds, spec, seconds, seed, prof):
    """Requests arrive on the mix's schedule while the window is open and
    go out over the connections in their order of arrival; each counts
    from its arrival. Returns one list of records, by arrival."""
    pending: queue.Queue = queue.Queue()
    records, errors = [], []
    lock = threading.Lock()
    keeper = Keeper(spec["sample"], seed)

    def worker(k):
        while (item := pending.get()) is not None:
            arrived, req = item
            try:
                rec = send(conns[k], req, bounds[k], 0, prof is not None,
                           arrived)
                with lock:
                    records.append(rec)
                    keeper.add(records)
            except Exception as e:  # noqa: BLE001 (raised below)
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,),
                                name=f"portbench-connection-{k}")
               for k in range(len(conns))]
    for t in threads:
        t.start()
    window = traffic.clients[0].window
    t_open = time.perf_counter()
    for t in traffic.arrivals:
        if t >= seconds:
            break
        while (now := time.perf_counter() - t_open) < t:
            if prof is not None:
                prof.tick(now)
            time.sleep(min(t - now, 0.005))
        if prof is not None:
            prof.tick(time.perf_counter() - t_open)
        pending.put((t_open + t, next(window)))
    for _ in threads:
        pending.put(None)
    for t in threads:
        t.join()
    if prof is not None:
        prof.finish()
    if errors:
        raise errors[0]
    return [sorted(records, key=lambda r: r.sent)]


def round_trips(records, opened, chunk_s: float = 5.0) -> dict:
    """How the window's round trips spread: quantiles in ms, the requests
    that took over 50 ms and their seconds, and the median of each
    ``chunk_s`` of the window (for reading noise, not compared)."""
    ms = sorted(1e3 * r.seconds for r in records)
    chunks: dict[int, list] = {}
    for r in records:
        chunks.setdefault(int((r.sent - opened) // chunk_s), []).append(
            1e3 * r.seconds)
    return {"median_ms": statistics.median(ms), "p99_ms": percentile(ms, 99),
            "max_ms": ms[-1], "over_50ms": sum(t > 50 for t in ms),
            "over_50ms_s": sum(t for t in ms if t > 50) / 1e3,
            "chunk_medians_ms": [statistics.median(chunks[k])
                                 for k in sorted(chunks)]}


def run(name: str, seed: int, seconds: float, trace: bool, device,
        started: float | None = None, bench: dict | None = None,
        base: str = HERE) -> tuple[dict, dict]:
    """One run of cell ``name`` on ``device``: (result, checks). ``bench``
    and ``base`` name another benchmark's entries and files."""
    import torch

    from portbench import peaks, traffic
    from portbench.trace import Profiler
    from portbench.trace import warm as warm_profiler

    started = time.perf_counter() if started is None else started
    stages = {}

    def stage(label):
        stages[label] = time.perf_counter() - started

    set_environment()
    bench = registry.benchmark() if bench is None else bench
    spec = registry.cell(bench, name, base)
    cfg = spec["config_file"]
    plan = traffic.plan(spec["mix"], seed)
    on_card = device.type == "cuda"
    stage("imports")
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    stage("device")

    httpd, thread = serve(device)
    port = httpd.server_address[1]
    loop = closed_loop if plan.arrival["kind"] == "closed" else open_loop
    n_conns = (len(plan.clients) if loop is closed_loop
               else plan.arrival["connections"])
    conns = [Client("127.0.0.1", port) for _ in range(n_conns)]
    spans = Spans(spec["spans"] if trace else {})
    try:
        stage("server")
        warm_bound: dict = {}
        for req in plan.warmup:
            if send(conns[0], req, warm_bound).reply is None:
                raise RuntimeError(f"warm-up {req.route} failed")
        stage("warmup")
        bounds = [{} for _ in conns]
        setups = []
        for k, client in enumerate(plan.clients):
            setups.append([send(conns[k], req, bounds[k], k)
                           for req in client.setup])
            if any(r.reply is None for r in setups[k]):
                raise RuntimeError(f"set-up of client {k} failed")
        for k in range(len(plan.clients), n_conns):     # an open loop's
            bounds[k] = dict(bounds[0])
        if on_card:
            torch.cuda.synchronize(device)
        stage("setup")
        setup_s = stages["setup"]

        before = counter_values(spec["counters"])
        prof = None
        if trace:
            warm_profiler()
            t = spec["trace"]
            prof = Profiler(t["start_s"], t["seconds"], t["pad_s"])
            spans.install()
        try:
            windows = loop(conns, plan, bounds, spec, seconds, seed, prof)
        finally:
            spans.remove()
        after = counter_values(spec["counters"])
        memory_peak = (max(torch.cuda.max_memory_allocated(i)
                           for i in range(spec["chips"])) if on_card else 0)
        for k, client in enumerate(plan.clients):
            for req in client.close:
                send(conns[k], req, bounds[k], k)
    finally:
        for c in conns:
            c.close()
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    records = [r for w in windows for r in w]
    opened, closed = window_bounds([(r.sent, r.received) for r in records])
    ctx = SimpleNamespace(
        config=cfg, cell=spec, requests=records, window_s=closed - opened,
        spans={k: [s for s in v if opened <= s[0] <= closed]
               for k, v in spans.spans.items()},
        counters={k: after[k] - before[k] for k in after},
        trace=prof.trace if prof is not None else None)
    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    for m in registry.metrics_for(bench, section, name):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            kind = "layer_metrics" if trace else "end_to_end"
            value = registry.load_module(kind, m["name"], base).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    failed = sum(r.reply is None for r in records)
    reference = registry.load_module("configs", spec["config"], base)
    clients = [SimpleNamespace(setup=s, window=w)
               for s, w in zip(setups, windows)]
    readings = reference.numbers(clients, cfg, device)
    checks = {k: {"value": v, "limit": cfg["limits"][k]}
              for k, v in readings.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": spec["chips"], "memory_peak_bytes": memory_peak}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    if on_card:
        result["card"] = peaks.card()
    result["window"] = {"seconds": ctx.window_s, "setup_stages": stages,
                        "counters": ctx.counters,
                        "round_trips": round_trips(records, opened)}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = registry.cell(registry.benchmark(), args.workload)
    apply_host(spec["config_file"].get("host", {}))

    import torch

    chips = spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0), started)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
