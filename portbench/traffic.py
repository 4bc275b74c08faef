"""The one traffic generator: it reads a traffic mix (``traffic/<mix>.json``,
parameters only) and a seed, and gives the requests of a run.

A mix holds:

- ``arrival``: how the window's requests follow one another.
  ``{"kind": "closed", "clients": n}``: n clients, each on a connection of
  its own, each sending its next request as soon as its last one has
  answered. ``{"kind": "open", "rate_per_s": r, "bursts": [sizes],
  "block": b, "connections": k}``: bursts of requests arrive at r requests
  a second on average, and k connections send them in their order of
  arrival. Each block of b bursts takes every size of ``bursts`` alike
  often and b gaps at an exponential law's quantiles (scaled to the mean
  rate), in an order the seed shuffles: every seed offers the same load.
- ``files``: named airfoil files, each made by a maker,
  ``airfoils/<maker>.py`` (``make(spec, rng) -> (file name, bytes)``),
  from its parameters: once a client (``"per": "client"``, the default) or
  anew for each request that sends it (``"per": "request"``).
- ``values``: named values that requests draw (``stream``), one draw a
  request that names them.
- ``block``: the length of the blocks over which ``strata`` and ``each``
  values are balanced.
- ``warmup``, ``setup``, ``window``, ``close``: request templates. The
  warm-up runs once, on the first client's connection, before set-up; each
  client then runs the set-up, the window's templates in turn and over
  again while the window is open, and the close. Only ``window`` may not be
  empty.

A template holds ``route``; ``fields`` (name -> text or number, or
``"{name}"``: a value drawn for this request, or else a key of an earlier
reply, which the runner fills in as it sends the request); ``files`` (form
field -> a name in ``files``); ``bind`` (keys of the reply that later
requests may name); and, in warm-up and set-up, ``repeat`` (that many
requests of it).

Each value and file draws from a stream of its own, seeded by the run's
seed, the client and its name, or by its ``fixed_seed`` in place of the
run's seed (a warm-up that is the same in every run): adding an entry to a
mix leaves the others' draws as they were.
"""

from __future__ import annotations

import itertools
import math
import re
import zlib
from dataclasses import dataclass, field

import numpy as np

from portbench import registry

_NAME = re.compile(r"^\{(\w+)\}$")


@dataclass
class Request:
    route: str
    fields: dict                       # name -> text
    files: dict = field(default_factory=dict)   # name -> (file name, bytes)
    bind: tuple = ()       # keys of the reply that later requests may name


@dataclass
class Plan:
    """One client's requests."""
    setup: list
    window: object         # an endless iterator of requests
    close: list


@dataclass
class Traffic:
    warmup: list           # run once, first client's connection, untimed
    clients: list          # one Plan a client (one for an open loop)
    arrival: dict
    arrivals: object = None     # open loop: arrival times from the window's
    #                             opening, in seconds, endless


def rng_for(seed: int, client: int, name: str, spec) -> np.random.Generator:
    """The stream of entry ``name`` of ``client``: from the run's seed, or
    from the entry's ``fixed_seed``."""
    if isinstance(spec, dict) and "fixed_seed" in spec:
        seed, client = spec["fixed_seed"], 0
    return np.random.default_rng(
        [seed % 2 ** 64, client, zlib.crc32(name.encode())])


def _on_grid(x: float, lo: float, grid: float | None) -> float:
    if not grid:
        return float(x)
    return round(lo + round((x - lo) / grid) * grid, 10)


def stream(spec, rng: np.random.Generator, block: int):
    """The endless draws of one ``values`` entry: a literal;
    ``{"uniform": [lo, hi], "grid": g}`` (on the grid from lo, where
    given); ``{"strata": [lo, hi], "grid": g}``: a block's values
    take one point of the grid from each of ``block`` equal strata of
    [lo, hi], shuffled; ``{"each": [...]}``: a block holds each value
    alike often, shuffled; ``{"slider": {"start", "every", "steps",
    "range"}}``: ``start``, moved every ``every`` draws by one of ``steps``
    with a drawn sign, turned back where it would leave ``range``."""
    if not isinstance(spec, dict):
        yield from itertools.repeat(spec)
    elif "uniform" in spec:
        lo, hi = spec["uniform"]
        while True:
            yield _on_grid(rng.uniform(lo, hi), lo, spec.get("grid"))
    elif "strata" in spec:
        yield from _strata(spec, rng, block)
    elif "each" in spec:
        values = list(spec["each"])
        if block % len(values):
            raise ValueError(f"a block of {block} cannot hold each of "
                             f"{len(values)} values alike often")
        while True:
            draws = values * (block // len(values))
            yield from (draws[i] for i in rng.permutation(block))
    elif "slider" in spec:
        yield from slider(spec["slider"], rng)
    else:
        raise ValueError(f"unknown value {spec!r}")


def _strata(spec: dict, rng: np.random.Generator, block: int):
    lo, hi = spec["strata"]
    grid = spec["grid"]
    width = (hi - lo) / block
    points = [_on_grid(lo + k * grid, lo, grid)
              for k in range(int(round((hi - lo) / grid)) + 1)]
    strata = [[p for p in points
               if lo + k * width <= p < lo + (k + 1) * width
               or (k == block - 1 and p == hi)] for k in range(block)]
    if not all(strata):
        raise ValueError(f"a stratum of {spec!r} holds no grid point")
    while True:
        draws = [s[int(rng.integers(len(s)))] for s in strata]
        yield from (draws[i] for i in rng.permutation(block))


def slider(spec: dict, rng: np.random.Generator):
    lo, hi = spec["range"]
    alpha = spec["start"]
    for k in itertools.count():
        if k and k % spec["every"] == 0:
            step = float(rng.choice(spec["steps"])) * float(rng.choice([-1, 1]))
            if not lo <= alpha + step <= hi:
                step = -step
            alpha += step
        yield alpha


def text(v) -> str:
    """A form field's text: floats by ``repr``."""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


class Client:
    """The draws of one client: its values' and files' streams."""

    def __init__(self, mix: dict, seed: int, index: int):
        self.mix, self.block = mix, mix.get("block", 1)
        self.values = {n: stream(s, rng_for(seed, index, "value " + n, s),
                                 self.block)
                       for n, s in mix.get("values", {}).items()}
        self.file_rngs = {n: rng_for(seed, index, "file " + n, s)
                          for n, s in mix.get("files", {}).items()}
        self.kept: dict = {}

    def file(self, name: str) -> tuple[str, bytes]:
        spec = self.mix["files"][name]
        if spec.get("per", "client") == "client" and name in self.kept:
            return self.kept[name]
        made = registry.load_module("airfoils", spec["maker"]).make(
            spec, self.file_rngs[name])
        self.kept[name] = made
        return made

    def request(self, t: dict) -> Request:
        drawn: dict = {}

        def value(name):
            if name not in drawn:
                spec = self.mix["values"][name]
                if isinstance(spec, dict) and "add" in spec:
                    drawn[name] = sum(value(a) if isinstance(a, str) else a
                                      for a in spec["add"])
                else:
                    drawn[name] = next(self.values[name])
            return drawn[name]

        fields = {}
        for k, v in t.get("fields", {}).items():
            m = _NAME.match(v) if isinstance(v, str) else None
            if m and m.group(1) in self.mix.get("values", {}):
                v = value(m.group(1))
            fields[k] = text(v)
        files = {k: self.file(n) for k, n in t.get("files", {}).items()}
        return Request(t["route"], fields, files, tuple(t.get("bind", ())))

    def requests(self, templates: list) -> list:
        return [self.request(t) for t in templates
                for _ in range(t.get("repeat", 1))]

    def endless(self, templates: list):
        for t in itertools.cycle(templates):
            yield self.request(t)


def arrivals(spec: dict, seed: int):
    """Open loop: arrival times, in seconds from the window's opening."""
    rng = np.random.default_rng([seed % 2 ** 64, zlib.crc32(b"arrivals")])
    sizes, block = list(spec["bursts"]), spec["block"]
    if block % len(sizes):
        raise ValueError(f"a block of {block} bursts cannot hold each of "
                         f"{len(sizes)} sizes alike often")
    quantiles = [-math.log(1.0 - (k + 0.5) / block) for k in range(block)]
    mean_gap = float(np.mean(sizes)) / spec["rate_per_s"]
    gaps = [q * mean_gap * block / sum(quantiles) for q in quantiles]
    t = 0.0
    while True:
        burst = sizes * (block // len(sizes))
        for i, j in zip(rng.permutation(block), rng.permutation(block)):
            t += gaps[i]
            yield from itertools.repeat(t, burst[j])


def plan(mix: dict, seed: int) -> Traffic:
    arrival = mix["arrival"]
    if arrival["kind"] == "closed":
        n = arrival["clients"]
    elif arrival["kind"] == "open":
        n = 1
    else:
        raise ValueError(f"unknown arrival {arrival['kind']!r}")
    clients = [Client(mix, seed, i) for i in range(n)]
    warmup = clients[0].requests(mix.get("warmup", []))
    plans = [Plan(c.requests(mix.get("setup", [])), c.endless(mix["window"]),
                  c.requests(mix.get("close", []))) for c in clients]
    return Traffic(warmup, plans, arrival,
                   arrivals(arrival, seed) if arrival["kind"] == "open"
                   else None)
