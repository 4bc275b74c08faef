"""The port's stage timer, forced fetch and trace
(``airfoil_tpu_torch.utils.profiling``) against the JAX package's on the
CPU.

``Timings`` and ``stage_timer`` must accumulate and round as the
reference's (on the same scripted clock); ``device_sync`` must return the
reference's float on the same seeded data; ``profile_trace`` must write a
Chrome trace that names the operations run inside it, also when the block
raises. The card's side (synchronising a CUDA device, a trace of a CUDA
kernel) is ``chip_smoke.py``'s phase 30.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.utils import profiling as ref_profiling
from airfoil_tpu_torch.utils import profiling
from airfoil_tpu_torch.utils import Timings, stage_timer


class _Clock:
    """A scripted ``time`` module: perf_counter returns the next value."""

    def __init__(self, values):
        self._values = iter(values)

    def perf_counter(self):
        return next(self._values)


def test_exports():
    assert (Timings, stage_timer) == (profiling.Timings,
                                      profiling.stage_timer)


@pytest.mark.parametrize("ndigits", [2, 4, 7])
def test_timings_accumulate_and_round(ndigits):
    rng = np.random.default_rng(ndigits)
    names = rng.choice(["parse", "operator", "solve"], 12)
    secs = rng.exponential(0.3, 12)
    got, want = profiling.Timings(), ref_profiling.Timings()
    for name, s in zip(names, secs):
        got.record(str(name), float(s))
        want.record(str(name), float(s))
    assert got.stages == want.stages
    assert got.as_dict(ndigits) == want.as_dict(ndigits)
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("sync", [True, False])
def test_stage_timer(sync, monkeypatch):
    """Two blocks of one name and one of another, the last raising: the
    same stages on the same clock."""
    ticks = [0.5, 0.75, 1.0, 1.125, 2.0, 2.0625]
    out = {}
    for name, mod in (("port", profiling), ("jax", ref_profiling)):
        monkeypatch.setattr(mod, "time", _Clock(ticks))
        t = mod.Timings()
        with mod.stage_timer(t, "solve", sync=sync):
            pass
        with mod.stage_timer(t, "solve", sync=sync):
            pass
        with pytest.raises(ValueError):
            with mod.stage_timer(t, "render", sync=sync):
                raise ValueError("inside the block")
        out[name] = (t.stages, t.as_dict())
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"solve": 0.375, "render": 0.0625}


def _trees(seed: int):
    """Seeded data as (numpy tree, description): arrays of several shapes
    and dtypes, nested in lists, tuples and dicts (keys in sorted order,
    as JAX flattens them)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    c = rng.integers(-9, 9, (2, 2)).astype(np.int32)
    d = np.float32(rng.standard_normal())
    return [a, [b, a], (c, b), {"a": b, "b": c}, d,
            np.zeros((0, 3), np.float32), [], [[], (c,)]]


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("seed", range(3))
def test_device_sync_reads_as_jax(seed):
    for tree in _trees(seed):
        got = profiling.device_sync(_to(tree, lambda a: torch.as_tensor(a)))
        want = ref_profiling.device_sync(_to(tree, jnp.asarray))
        assert type(got) is float
        assert got == want, tree


def test_device_sync_without_argument():
    assert profiling.device_sync() == ref_profiling.device_sync() == 0.0


def _trace_files(log_dir) -> list:
    return sorted(glob.glob(os.path.join(str(log_dir), "trace_*.json")))


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(log_dir=str(tmp_path / "t")) as d:
        x = torch.randn(64, 64)
        torch.mm(x, x).sum()
    assert d == str(tmp_path / "t")
    (path,) = _trace_files(d)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_profile_trace_default_dir_and_error(tmp_path, monkeypatch):
    """Without ``log_dir`` the trace goes to the temporary directory; a
    block that raises still leaves its trace."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    with pytest.raises(RuntimeError):
        with profiling.profile_trace() as d:
            torch.ones(8).cumsum(0)
            raise RuntimeError("inside the trace")
    assert d == str(tmp_path / "airfoil_tpu_torch_trace")
    (path,) = _trace_files(d)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::cumsum" in names


def test_profile_trace_records_threads_started_before_it(tmp_path):
    """A span opened in a thread started before ``profile_trace`` (as a
    running server's request thread is) is in the written trace."""
    import threading

    start, done = threading.Event(), threading.Event()

    def request_thread():
        start.wait(timeout=30)
        with profiling.span("http /lbm/frame"):
            torch.ones(8).sum()
        done.set()

    t = threading.Thread(target=request_thread)
    t.start()
    with profiling.profile_trace(log_dir=str(tmp_path)) as d:
        start.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    (path,) = _trace_files(d)
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("http /lbm/frame") == 1
