"""The port's parser benchmark and paneling probe against the JAX
package's, with the solve scripted, so that what is held is each tool's
own logic on the same inputs:

- ``run_benchmark`` over the benchmark's corpus (``generate_corpus``, 64
  files): the geometries handed to the solve, the CSV byte for byte, and
  the summary (the reference's keys and values, plus ``device`` and
  ``card``);
- ``_batched_success``: the resampled, chunked and padded geometries that
  reach the solve equal the reference's bit for bit, and the verdicts
  come back to the same files;
- ``probe_strategies`` and the probe's CLI: the same plans reach the solve
  in the same order and the rows (but their times) are equal, an error
  row included;
- the classifiers' CLIs over the benchmark's CSV write the same files.

The solves themselves are held elsewhere (``tests/test_torch_lanes.py``
on the CPU, ``chip_smoke.py`` on the card).
"""

import csv
import importlib
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import airfoil_tpu.inviscid  # noqa: F401  (imported before jax.jit is faked)
import airfoil_tpu.paneling  # noqa: F401
import airfoil_tpu.viscous  # noqa: F401
from airfoil_tpu.bench import paneling_probe as jprobe
from airfoil_tpu.bench import parser_benchmark as jpb
from airfoil_tpu_torch.bench import paneling_probe as probe
from airfoil_tpu_torch.bench import parser_benchmark as pb
from airfoil_tpu_torch.bench.corpus import generate_corpus

N_FILES = 64


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                           n=N_FILES, seed=0)


def _scripted(seen):
    """A solve verdict from the geometry alone; records what it got."""
    def verdicts(geometries, device=None):
        seen.append(geometries)
        return [g is not None and (len(g) % 3 != 0) for g in geometries]
    return verdicts


def _csv(path):
    with open(os.path.join(path, "benchmark_results.csv"), "rb") as fh:
        return fh.read()


def test_run_benchmark_against_reference(corpus, tmp_path, monkeypatch):
    seen_port, seen_ref = [], []
    monkeypatch.setattr(pb, "_batched_success", _scripted(seen_port))
    monkeypatch.setattr(jpb, "_batched_success", _scripted(seen_ref))
    got = pb.run_benchmark(corpus, str(tmp_path / "port"), device="cpu")
    want = jpb.run_benchmark(corpus, str(tmp_path / "ref"))
    assert len(seen_port) == len(seen_ref) == 2
    for a_list, b_list in zip(seen_port, seen_ref):
        for a, b in zip(a_list, b_list):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert _csv(tmp_path / "port") == _csv(tmp_path / "ref")
    assert list(got) == list(want) + ["device", "card"]
    assert got["device"] == got["card"] == "cpu"
    for key in want:
        if key != "elapsed_seconds":
            assert got[key] == want[key], key
    with open(tmp_path / "port" / "benchmark_summary.json") as fh:
        assert json.load(fh) == got
    assert 0 < got["raw_converged"] < N_FILES and got["rescued"] > 0


def test_batched_success_chunks_against_reference(corpus, monkeypatch):
    """Both solves replaced by one that returns a verdict from each lane's
    first coordinate and records the chunks."""
    geometries = [np.asarray(pb.raw_coords_from_file(p)) for p in corpus]
    geometries = [g if len(g) >= 5 else None for g in geometries]
    geometries[3] = np.zeros((7, 2))                # no arc length
    ref_chunks, port_chunks = [], []

    def fake_jit(fn):
        def run(batch):
            batch = np.asarray(batch)
            ref_chunks.append(batch)
            return batch[:, 0, 0] > 0.5
        return run

    monkeypatch.setattr(jax, "jit", fake_jit)
    want = jpb._batched_success(geometries)
    monkeypatch.undo()

    monkeypatch.setattr(pb, "chunk_operators", lambda chunk, dev: chunk)
    monkeypatch.setattr(pb, "solve_chunk", lambda ops: ops)
    monkeypatch.setattr(pb, "plausible", lambda chunk: torch.as_tensor(
        port_chunks.append(chunk) or chunk[:, 0, 0] > 0.5))
    got = pb._batched_success(geometries, "cpu")
    assert got == want and any(got) and not all(got)
    assert len(port_chunks) == len(ref_chunks) == -(-N_FILES // pb.CHUNK)
    for a, b in zip(port_chunks, ref_chunks):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert a.shape == (pb.CHUNK, pb.RESAMPLE_POINTS, 2)


def _scripted_solve(calls, converged=True):
    def solve(coords, alpha, reynolds, **plan):
        plan.pop("device", None)
        calls.append((np.asarray(coords).tolist(), alpha, reynolds, plan))
        if plan.get("n_panels") == 220:
            raise ValueError("scripted failure")
        k = len(calls)
        return SimpleNamespace(cl=0.1 * k + 0.123456789,
                               cd=0.001 * k + 1.23456789e-4,
                               cm=-0.01 * k, sep_fraction=0.0271828 * k,
                               converged=converged and k % 2 == 1)
    return solve


def _rows(rows):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in rows]


def test_probe_strategies_against_reference(monkeypatch):
    loop = [[1.0, 0.0], [0.5, 0.06], [0.0, 0.0], [0.5, -0.04], [1.0, 0.0]]
    got_calls, want_calls = [], []
    monkeypatch.setattr(probe, "_solve_with", _scripted_solve(got_calls))
    monkeypatch.setattr(jprobe, "_solve_with", _scripted_solve(want_calls))
    got = probe.probe_strategies(np.asarray(loop), 5.0, 2e5, device="cpu")
    want = jprobe.probe_strategies(loop, 5.0, 2e5)
    assert _rows(got) == _rows(want)
    assert got_calls == want_calls
    assert [c[3] for c in got_calls] == [probe.PLANS[s]
                                        for s in probe.STRATEGIES]
    assert any("error" in r for r in got)


def test_probe_cli_against_reference(monkeypatch, tmp_path, capsys):
    """No row converges: the reference's ``--json`` cannot write a
    converged row (its verdict is a numpy bool; the port's is a bool, see
    ``test_probe_cli_writes_converged_rows``)."""
    got_calls, want_calls = [], []
    monkeypatch.setattr(probe, "_solve_with",
                        _scripted_solve(got_calls, converged=False))
    monkeypatch.setattr(jprobe, "_solve_with",
                        _scripted_solve(want_calls, converged=False))
    reports = []
    for mod, name in ((probe, "port"), (jprobe, "ref")):
        out = tmp_path / f"{name}.json"
        mod.main(["--naca", "2412", "--reynolds", "3e5", "--json", str(out)])
        with open(out) as fh:
            rep = json.load(fh)
        rep["rows"] = _rows(rep["rows"])
        reports.append(rep)
    assert reports[0] == reports[1]
    assert got_calls == want_calls
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "Probing NACA 2412 at Re=300000, alpha=5 deg"


def test_probe_cli_writes_converged_rows(monkeypatch, tmp_path):
    monkeypatch.setattr(probe, "_solve_with", _scripted_solve([]))
    out = tmp_path / "probe.json"
    probe.main(["--naca", "2412", "--json", str(out)])
    with open(out) as fh:
        rep = json.load(fh)
    assert rep["first_working"] == "baseline"
    assert [r["converged"] for r in rep["rows"]] == [True, False, True,
                                                     False, True]


@pytest.mark.parametrize("module", ["classify_failures", "classify_repairs"])
def test_classifier_clis_against_reference(module, corpus, tmp_path,
                                           monkeypatch):
    """Each classifier's CLI on the same benchmark CSV writes the same
    files."""
    monkeypatch.setattr(jpb, "_batched_success", _scripted([]))
    jpb.run_benchmark(corpus, str(tmp_path))
    data_dir = os.path.dirname(corpus[0])
    outs = []
    for pkg in ("airfoil_tpu_torch", "airfoil_tpu"):
        mod = importlib.import_module(f"{pkg}.bench.{module}")
        out = tmp_path / pkg
        out.mkdir()
        monkeypatch.setattr(sys, "argv", [
            module, "--csv", str(tmp_path / "benchmark_results.csv"),
            "--data-dir", data_dir, "--out", str(out)])
        mod.main()
        outs.append({f: (out / f).read_bytes()
                     for f in sorted(os.listdir(out))})
    assert outs[0] == outs[1] and len(outs[0]) == 2
    with open(tmp_path / "benchmark_results.csv") as fh:
        assert any(r["rescued"] == "True" for r in csv.DictReader(fh))
