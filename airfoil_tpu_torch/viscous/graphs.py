"""CUDA graphs of the Newton solve's Levenberg-Marquardt iteration, one a
shape key: the port's compiled-program layer.

The counterpart of the ``jax.jit`` caches of the reference's four Newton
entries (``airfoil_tpu/viscous/newton.py:748-900``), whose LM loop is a
``lax.while_loop`` compiled once per static shape. Eager PyTorch issues
one LM iteration's ~15,300 small operations from Python every time; a
graph captures them once and replays them without Python.

- **The unit is one LM iteration** (``newton._lm_body``), replayed
  ``newton_iters`` times a round. Its last operations copy the new
  (zz, lam) into its own static inputs, so replay k + 1 starts where
  replay k ended. A graph of a whole round would hold 12-14 x ~15,300
  nodes.
- **The key** (``lm_key``): the device, the lanes, the stations a side,
  the wake stations, whether the inviscid operator is shared by the lanes
  or stacked one a lane, and the panel nodes. These fix every shape of the
  iteration; everything else is data.
- **Static inputs.** The body is a plain function of a flat list of
  tensors (``[zz, lam, *newton._LMTensors]``); each call copies its list
  into the key's static buffers before it replays. The plan's constants
  and the numerics' cached constants are read by address: they are cached
  per shape and device and never freed. Nothing else is: a tensor read by
  address would replay the first solve's data.
- **Capture.** One eager iteration on the capture's own stream first
  (cuBLAS and cuSOLVER handles and workspaces, the device constant
  caches), then the capture, with ``capture_error_mode="thread_local"``:
  another thread's work during a capture neither breaks it nor is broken
  by it. One capture at a time in the process.
- **Concurrency.** Each key has a lock held from the inputs' copy to the
  outputs' read-back, and each call's read-back is an event the next
  call's stream waits for: two solves of one key never share the static
  buffers, on any streams.
- **Devices.** On a CUDA tensor a capture or replay failure raises;
  nothing falls back to eager dispatch. On a CPU tensor there are no
  graphs: ``run_lm`` calls the body eagerly (``_eager_lm``, the plain
  version beside the graph, which the tests and ``chip_smoke.py`` also
  hold the graph to on the card).

Counters, by key: ``captures`` (graphs captured), ``replays`` (LM
iterations replayed), ``pool_bytes`` (the reserved bytes of the graph's
private memory pool after its capture).
"""

from __future__ import annotations

import threading

import torch

__all__ = ["captures", "lm_key", "pool_bytes", "replays", "run_lm"]

captures: dict = {}     # key -> graphs captured
replays: dict = {}      # key -> LM iterations replayed
pool_bytes: dict = {}   # key -> the graph pool's reserved bytes
_GRAPHS: dict = {}      # key -> _Graph
_LOCK = threading.Lock()            # guards _GRAPHS and the counters
_CAPTURE_LOCK = threading.Lock()    # one capture at a time


def lm_key(system) -> tuple:
    """(device, lanes, stations a side, wake stations, operator shared by
    the lanes, panel nodes) of a ``newton._System``."""
    return (system.vt0.device, system.lanes, system.m_s, system.n_w,
            system.shared, system.op.pan.s.shape[-1])


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
    """One key's graph, its static inputs and its lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graph = None
        self.static: list = []
        self.done = None     # the last read-back's event

    def capture(self, key, body, flat: list) -> None:
        dev = flat[0].device
        static = [torch.empty_like(t) for t in flat]
        for s, t in zip(static, flat):
            s.copy_(t)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body(static)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                zz, lam = body(static)
                static[0].copy_(zz)
                static[1].copy_(lam)
            pool = graph.pool()
            reserved = sum(seg["total_size"]
                           for seg in torch.cuda.memory_snapshot()
                           if tuple(seg["segment_pool_id"]) == tuple(pool))
        self.graph, self.static = graph, static
        _count(captures, key, 1)
        with _LOCK:
            pool_bytes[key] = reserved

    def run(self, key, flat: list, iters: int):
        for s, t in zip(self.static, flat):
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(
                    f"LM graph {key}: input of shape {tuple(t.shape)} "
                    f"{t.dtype} for a static buffer of {tuple(s.shape)} "
                    f"{s.dtype}")
        stream = torch.cuda.current_stream(flat[0].device)
        if self.done is not None:
            stream.wait_event(self.done)
        for s, t in zip(self.static, flat):
            s.copy_(t)
        for _ in range(iters):
            self.graph.replay()
        out = self.static[0].clone(), self.static[1].clone()
        self.done = torch.cuda.Event()
        self.done.record(stream)
        _count(replays, key, iters)
        return out


def run_lm(key, body, flat: list, iters: int):
    """``iters`` LM iterations of ``body`` (``[zz, lam, *rest]`` ->
    (zz, lam)) from ``flat``: on a CUDA tensor by replaying ``key``'s graph
    (captured at the key's first call), on a CPU tensor eagerly. Returns
    the last (zz, lam)."""
    dev = flat[0].device
    if dev.type == "cpu":
        return _eager_lm(body, flat, iters)
    if dev.type != "cuda":
        raise ValueError(f"LM iterations run on cpu or cuda, not {dev}")
    with _LOCK:
        g = _GRAPHS.setdefault(key, _Graph())
    with g.lock:
        if g.graph is None:
            g.capture(key, body, flat)
        return g.run(key, flat, iters)
