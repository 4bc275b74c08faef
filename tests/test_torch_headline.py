"""The port's headline benchmark (``airfoil_tpu_torch.bench.headline``)
against the repository's ``bench.py`` on the CPU, with the polar scripted.

``solve_polar`` is replaced in both by the same script (a ``PolarResult``
whose modes follow a fixed mix, recording every call's inputs), and
``warm_polar_kernels`` by a no-op in both. The port's
``bench_polar`` must make the reference's calls (the warm-up, then one a
repetition with alpha perturbed by 0.001 a repetition) on the same
geometry and give the same point count, viscous fraction and mode counts,
in the reduced configuration and the full one. The reference runs in a
subprocess whose JAX compile cache is in ``tmp_path``: importing
``bench.py`` turns on the shared cache, which must not be used for CPU
runs. The record's ``parity`` holds the reference's four keys, read from
the port's committed report. ``--device cpu`` runs end to end (a scripted
polar, a 64x32 lattice) and prints the two lines in order; an error after
line 1 leaves line 1 printed and ends the run with it; without a card and
without ``--device cpu`` the CLI exits non-zero before any record.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from airfoil_tpu_torch.bench import headline
from airfoil_tpu_torch.polar import sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [0, 0, 1, 0, 2, 0, 0, 1, 2]      # the scripted polar's mode mix

_REFERENCE = r"""
import json
import numpy as np
import bench
import airfoil_tpu.polar as polar
from airfoil_tpu.polar.sweep import PolarResult

MODES = {modes!r}
calls = []

def solve_polar(coords, alphas, reynolds, n_panels=160):
    alphas = np.asarray(alphas)
    calls.append({{"alphas": alphas.tolist(), "dtype": str(alphas.dtype),
                  "reynolds": float(reynolds),
                  "coords": np.asarray(coords).tolist()}})
    p = len(alphas)
    mode = np.array([MODES[i % len(MODES)] for i in range(p)])
    z = np.zeros(p, np.float32)
    return PolarResult(alphas, z + reynolds, z, z, z, z, mode, mode != 2,
                       z, z, z)

polar.solve_polar = solve_polar
polar.warm_polar_kernels = lambda **kw: None
out = {{}}
for reduced in (True, False):
    calls.clear()
    out[str(reduced)] = {{"polar": bench.bench_polar(reduced=reduced),
                         "calls": list(calls)}}
out["parity"] = bench._parity_extra()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``bench.py``'s scripted results in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               AIRFOIL_TPU_JAX_CACHE=str(tmp_path_factory.mktemp("jaxc")),
               PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(modes=MODES)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def scripted(monkeypatch):
    """The port's ``solve_polar`` scripted as the reference's (and its
    ``warm_polar_kernels`` a no-op); yields the list of its calls."""
    calls = []

    def solve_polar(coords, alphas, reynolds, n_panels=160, device=None):
        alphas = np.asarray(alphas)
        calls.append({"alphas": alphas.tolist(), "dtype": str(alphas.dtype),
                      "reynolds": float(reynolds),
                      "coords": np.asarray(coords).tolist(),
                      "device": str(device)})
        p = len(alphas)
        mode = np.array([MODES[i % len(MODES)] for i in range(p)])
        z = np.zeros(p, np.float32)
        return sweep.PolarResult(alphas, z + reynolds, z, z, z, z, mode,
                                 mode != 2, z, z, z)

    monkeypatch.setattr(sweep, "solve_polar", solve_polar)
    monkeypatch.setattr(sweep, "warm_polar_kernels", lambda **kw: None)
    yield calls


@pytest.mark.parametrize("reduced", [True, False])
def test_bench_polar_as_reference(reduced, reference, scripted):
    got = headline.bench_polar(reduced=reduced, device="cpu")
    want = reference[str(reduced)]
    for key in ("n_points", "viscous_fraction", "mode_counts"):
        assert got[key] == want["polar"][key], key
    assert got["n_points"] == (11 if reduced else 31)
    assert got["reps"] == (1 if reduced else 3)
    assert len(scripted) == len(want["calls"]) == 1 + got["reps"]
    for mine, ref in zip(scripted, want["calls"]):
        assert mine["device"] == "cpu"
        del mine["device"]
        assert mine == ref
    assert got["launches"] == {"bl_march": 0, "bl_march_wake": 0}
    assert got["points_per_sec"] == got["n_points"] / got["polar_seconds"]


def test_reps_option(scripted):
    got = headline.bench_polar(reps=2, device="cpu")
    assert got["reps"] == 2 and len(scripted) == 3
    assert [c["alphas"][0] for c in scripted] == \
        [np.float32(-10.0), np.float32(-10.0), np.float32(-10.0 + 0.001)]
    with pytest.raises(ValueError):
        headline.bench_polar(reps=0, device="cpu")


def test_parity_extra(reference):
    got = headline._parity_extra()
    assert list(got) == list(reference["parity"])
    with open(os.path.join(ROOT, "airfoil_tpu_torch", "bench", "results",
                           "parity_report.json")) as f:
        report = json.load(f)
    assert got == {k: report[k] for k in got}


def test_polar_record(reference, scripted):
    polar = headline.bench_polar(reduced=True, device="cpu")
    rec = headline.polar_record(polar, torch.device("cpu"), None)
    assert rec["metric"] == "viscous_polar_points_per_sec"
    assert rec["unit"] == "points/sec"
    assert rec["value"] == polar["points_per_sec"]
    assert rec["vs_baseline"] == pytest.approx(polar["points_per_sec"] * 30.0,
                                               rel=1e-12)
    ex = rec["extra"]
    assert (ex["platform"], ex["device"], ex["card"]) == ("cpu", "cpu", None)
    assert ex["mode_counts"] == reference["True"]["polar"]["mode_counts"]
    assert ex["polar_seconds_31pts"] == polar["polar_seconds"]
    assert ex["parity"] == headline._parity_extra()


def _main(argv) -> tuple[list, BaseException | None]:
    out, err = io.StringIO(), None
    with redirect_stdout(out):
        try:
            headline.main(argv)
        except Exception as e:                      # noqa: BLE001
            err = e
    return [json.loads(x) for x in out.getvalue().splitlines()], err


def test_cli_cpu_end_to_end(scripted, monkeypatch):
    monkeypatch.setattr(headline, "CPU_LBM_GRIDS", (
        ("main", dict(nx=64, ny=32, steps_per_call=4, n_calls=2)),))
    lines, err = _main(["--device", "cpu"])
    assert err is None
    assert [x["metric"] for x in lines] == ["viscous_polar_points_per_sec",
                                            "lbm_mlups"]
    for x in lines:
        assert x["extra"]["platform"] == "cpu"
        assert x["extra"]["device"] == "cpu"
    assert lines[0]["extra"]["n_points"] == 11
    lbm = lines[1]
    assert lbm["extra"]["grid"] == "64x32" and lbm["extra"]["steps"] == 8
    assert lbm["value"] > 0
    run = lbm["extra"]["runs"]["main"]
    assert (run["kernel"], run["tiled"]) == (False, False)
    assert run["launches"] == {"lbm_steps": 0, "lbm_steps_tiled": 0,
                               "cell_word": 0}


def test_cli_lbm_error_keeps_line_one(scripted, monkeypatch):
    def broken(**kw):
        raise RuntimeError("lbm failed")

    monkeypatch.setattr(headline, "bench_mlups", broken)
    lines, err = _main(["--device", "cpu"])
    assert isinstance(err, RuntimeError)
    assert [x["metric"] for x in lines] == ["viscous_polar_points_per_sec"]


def test_cli_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    env = dict(os.environ, AIRFOIL_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "airfoil_tpu_torch.bench.headline"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
