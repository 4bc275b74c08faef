"""CUDA graphs of the port's compiled programs, one a program and shape
key: the port's compiled-program layer.

The counterparts of the reference's ``jax.jit`` programs, each compiled
once per static shape there. Eager PyTorch issues every small operation
of such a program from Python every time; a graph captures them once and
replays them without Python. The programs of the solver:

- ``"lm"``: one Levenberg-Marquardt iteration (``newton._lm_body``),
  replayed ``newton_iters`` times a round (``run_lm``). Its last
  operations copy the new (zz, lam) into its own static inputs, so replay
  k + 1 starts where replay k ended. Keyed by ``lm_key``: the device, the
  lanes, the stations a side, the wake stations, whether the inviscid
  operator is shared by the lanes or stacked one a lane, and the panel
  nodes.
- ``"direct"``: the whole direct solve, ``coupled.solve_viscous``
  (``airfoil_tpu/viscous/coupled.py:294``), its ``coupling_iters`` + 1
  passes in one graph.
- ``"prepare"``, ``"reproject"``, ``"settle"``, ``"answer"``: the rest of
  a Newton solve (``airfoil_tpu/viscous/newton.py:748-900``): the lanes'
  set-up and warm start, a round's re-projection before its LM iterations
  and its residual and lane bookkeeping after them, the lanes' answer with
  its oracle march (``newton._prepare``, ``_lm_rounds``, ``_lane_answer``).

And the programs around it (``airfoil_tpu/polar/sweep.py:367-380``,
``airfoil_tpu/inviscid/panel_solver.py:371``,
``airfoil_tpu/lbm/diagnostics.py:25,55``):

- ``"operator"``: coordinates to an inviscid operator
  (``inviscid.programs.operator_program``: repanel, the smoothing where
  asked, the paneling and the influence fill; then the source
  sensitivities through the factor). Two graphs a key, around the LU
  factor, which runs eagerly between them: torch factors a batch of
  matrices through MAGMA, whose batched factor cannot be captured.
- ``"inviscid"``: the standalone inviscid solve
  (``inviscid.programs.inviscid_program``).
- ``"frame"``: the wind tunnel's frame diagnostics, the forces and
  separation share and the five fields (``lbm.diagnostics.frame_fields``);
  the LBM step before them stays its own kernel launch.

Each program is a plain function of a flat list of tensors (``flatten``
and ``unflatten`` turn nested tuples, named tuples and dicts of tensors
into such a list and back); its key fixes every shape and every Python
number the body reads, everything else is data (``as_input`` makes a
call's numbers tensors before the body).

- **Static inputs.** Each call copies its list into the key's static
  buffers before it replays. The plans' constants and the numerics'
  cached constants are read by address: they are cached per shape and
  device and never freed. Nothing else is: a tensor read by address would
  replay the first call's data.
- **Outputs** are read back as clones made under the key's lock, so a
  later call of the key never overwrites what an earlier caller holds.
- **Capture.** One eager call on the capture's own stream first (cuBLAS
  and cuSOLVER handles and workspaces, the device constant caches, the
  kernel libraries), then the capture, with
  ``capture_error_mode="thread_local"``: another thread's work during a
  capture neither breaks it nor is broken by it. One capture at a time in
  the process.
- **Concurrency.** Each key has a lock held from the inputs' copy to the
  outputs' read-back, and each call's read-back is an event the next
  call's stream waits for: two calls of one key never share the static
  buffers, on any streams.
- **March launches.** ``viscous.kernel`` counts its launches in Python,
  which a replay does not run: the launches of a capture (and of its warm
  call) are tallied instead of counted, and every replay adds its graph's
  tally to ``kernel.march_launches`` and ``kernel.wake_launches``.
- **Devices.** On a CUDA tensor a capture or replay failure raises;
  nothing falls back to eager dispatch. On a CPU tensor there are no
  graphs: ``run`` and ``run_lm`` call the body eagerly (``_eager_lm`` is
  the LM round's plain version, which the tests and ``chip_smoke.py``
  also hold the graph to on the card).

Counters, by (program, key): ``captures`` (graphs captured), ``replays``
(replays: LM iterations for ``"lm"``, calls for the others),
``pool_bytes`` (the reserved bytes of the graph's private memory pool
after its capture); ``total`` sums one program's.
"""

from __future__ import annotations

import threading

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from airfoil_tpu_torch.utils.profiling import span
from airfoil_tpu_torch.viscous import kernel

__all__ = ["PROGRAMS", "as_input", "captures", "flatten", "lm_key",
           "pool_bytes", "replays", "run", "run_lm", "total", "unflatten"]

PROGRAMS = ("lm", "direct", "prepare", "reproject", "settle", "answer",
            "operator", "inviscid", "frame")

captures: dict = {}     # (program, key) -> graphs captured
replays: dict = {}      # (program, key) -> replays
pool_bytes: dict = {}   # (program, key) -> the graph pool's reserved bytes
_GRAPHS: dict = {}      # (program, key) -> _Graph
_LOCK = threading.Lock()            # guards _GRAPHS and the counters
_CAPTURE_LOCK = threading.Lock()    # one capture at a time


def lm_key(system) -> tuple:
    """(device, lanes, stations a side, wake stations, operator shared by
    the lanes, panel nodes) of a ``newton._System``."""
    return (system.vt0.device, system.lanes, system.m_s, system.n_w,
            system.shared, system.op.pan.s.shape[-1])


def as_input(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor of ``like``'s type on its device, for a program's
    flat list: a number made a tensor inside a body would be frozen into
    the graph at its capture. A number is filled in on the device, not
    copied there from the host."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return torch.full((), float(v), dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def total(counter: dict, program: str | None = None) -> int:
    """``counter`` summed over every key of ``program`` (of every program
    with None)."""
    with _LOCK:
        return sum(n for (prog, _key), n in counter.items()
                   if program is None or prog == program)


def flatten(tree) -> tuple[list, tuple]:
    """The tensors of ``tree`` (tensors and None in tuples, lists, named
    tuples and dicts, as ``torch.utils._pytree`` flattens them) and its
    structure for ``unflatten``. Any other leaf raises: a number would be
    frozen into a graph."""
    leaves, spec = tree_flatten(tree)
    for leaf in leaves:
        if leaf is not None and not isinstance(leaf, torch.Tensor):
            raise TypeError(f"a graph's inputs and outputs are tensors, not "
                            f"{type(leaf).__name__}")
    return ([t for t in leaves if t is not None],
            (spec, tuple(t is None for t in leaves)))


def unflatten(spec: tuple, flat) -> object:
    """The tree of ``flatten``'s structure ``spec`` over its tensors."""
    tree_spec, none = spec
    it = iter(flat)
    return tree_unflatten([None if n else next(it) for n in none], tree_spec)


def _eager_lm(body, flat: list, iters: int):
    """``iters`` calls of ``body`` from ``flat``'s (zz, lam), eagerly."""
    zz, lam, *rest = flat
    for _ in range(iters):
        zz, lam = body([zz, lam, *rest])
    return zz, lam


def _count(counter: dict, key, n: int) -> None:
    with _LOCK:
        counter[key] = counter.get(key, 0) + n


class _Graph:
    """One key's graph, its static inputs and outputs, and its lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graph = None
        self.static: list = []
        self.outs: list = []     # the graph's output tensors
        self.spec = None         # their structure
        self.launches: dict = {}     # march launches of one replay
        self.done = None         # the last read-back's event

    def capture(self, key, body, flat: list, feedback: bool) -> None:
        """Capture ``body`` on static copies of ``flat``, traced as the
        span ``graphs.capture <program>``. With ``feedback`` the body's
        outputs are copied into the first static inputs inside the graph,
        and those are its outputs."""
        with span(f"graphs.capture {key[0]}"):
            self._capture(key, body, flat, feedback)

    def _capture(self, key, body, flat: list, feedback: bool) -> None:
        dev = flat[0].device
        static = [torch.empty_like(t) for t in flat]
        for s, t in zip(static, flat):
            s.copy_(t)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), kernel.tallied():
                body(static)
            with kernel.tallied() as launches, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                out = body(static)
                if feedback:
                    for s, o in zip(static, out):
                        s.copy_(o)
                    out = tuple(static[:len(out)])
            pool = graph.pool()
            reserved = sum(seg["total_size"]
                           for seg in torch.cuda.memory_snapshot()
                           if tuple(seg["segment_pool_id"]) == tuple(pool))
        self.outs, self.spec = flatten(out)
        self.graph, self.static, self.launches = graph, static, launches
        _count(captures, key, 1)
        with _LOCK:
            pool_bytes[key] = reserved

    def run(self, key, flat: list, iters: int):
        if len(flat) != len(self.static):
            raise ValueError(f"graph {key}: {len(flat)} inputs for "
                             f"{len(self.static)} static buffers")
        for s, t in zip(self.static, flat):
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(
                    f"graph {key}: input of shape {tuple(t.shape)} "
                    f"{t.dtype} for a static buffer of {tuple(s.shape)} "
                    f"{s.dtype}")
        stream = torch.cuda.current_stream(flat[0].device)
        if self.done is not None:
            stream.wait_event(self.done)
        for s, t in zip(self.static, flat):
            s.copy_(t)
        for _ in range(iters):
            self.graph.replay()
        kernel.add_launches(self.launches, iters)
        out = [o.clone() for o in self.outs]
        self.done = torch.cuda.Event()
        self.done.record(stream)
        _count(replays, key, iters)
        return unflatten(self.spec, out)


def _replayed(program: str, key, body, flat: list, iters: int,
              feedback: bool):
    dev = flat[0].device
    if dev.type != "cuda":
        raise ValueError(f"{program} runs on cpu or cuda, not {dev}")
    gkey = (program, key)
    with _LOCK:
        g = _GRAPHS.setdefault(gkey, _Graph())
    with g.lock:
        if g.graph is None:
            g.capture(gkey, body, flat, feedback)
        return g.run(gkey, flat, iters)


def run(program: str, key, body, flat: list):
    """``body(flat)`` (a flat list of tensors -> tensors in tuples, named
    tuples and dicts): on a CUDA tensor by replaying the graph of
    (``program``, ``key``), captured at its first call; on a CPU tensor
    eagerly."""
    if flat[0].device.type == "cpu":
        return body(flat)
    return _replayed(program, key, body, flat, 1, feedback=False)


def run_lm(key, body, flat: list, iters: int):
    """``iters`` LM iterations of ``body`` (``[zz, lam, *rest]`` ->
    (zz, lam)) from ``flat``: on a CUDA tensor by replaying ``key``'s graph
    (captured at the key's first call), on a CPU tensor eagerly. Returns
    the last (zz, lam)."""
    if flat[0].device.type == "cpu":
        return _eager_lm(body, flat, iters)
    return _replayed("lm", key, body, flat, iters, feedback=True)
