"""What the benchmark runs imports neither JAX nor the JAX package, by whole
top-level name, and the plain references import nothing of the program."""

import os
import subprocess
import sys

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REFUSE = """
import sys
BANNED = set(sys.argv[1].split(","))
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("refused " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {root!r})
"""

HARNESS = REFUSE + """
import torch
from portbench import run
res, checks = run.run("tunnel.viewer-384", 2 ** 31 + 5, 1.0, False,
                      torch.device("cpu"))
assert res["attempted"] > 0 and res["correct"], res
assert not run.forbidden_modules(), run.forbidden_modules()
print("ok")
"""

REFERENCE = REFUSE + """
import torch
from portbench import control
checks = control.control("tunnel.viewer-384", 3, 6, torch.device("cpu"),
                         torch.float32)
assert all(c["value"] <= c["limit"] for c in checks.values()), checks
assert not [m for m in sys.modules
            if m.split(".")[0] == "airfoil_tpu_torch"]
print("ok")
"""


def _python(code: str, banned: str, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, "-c", code.format(root=ROOT),
                           banned], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env=env)


def test_portbench_harness_runs_without_jax(tmp_path):
    out = _python(HARNESS, "jax,jaxlib,flax,airfoil_tpu", tmp_path)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-3000:]


def test_portbench_reference_imports_nothing_of_the_program(tmp_path):
    out = _python(REFERENCE, "jax,jaxlib,flax,airfoil_tpu,airfoil_tpu_torch",
                  tmp_path)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-3000:]


def test_portbench_forbidden_modules_compared_by_whole_name(monkeypatch):
    for name in ("airfoil_tpu_torch", "airfoil_tpu_torch.api",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert [m for m in run.forbidden_modules()
            if m.split(".")[0] in ("airfoil_tpu_torch", "jaxtyping",
                                   "flaxen")] == []
    monkeypatch.setitem(sys.modules, "airfoil_tpu.lbm", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert {"airfoil_tpu.lbm", "jax"} <= set(run.forbidden_modules())


def test_portbench_no_card_exits_without_a_result(tmp_path):
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tunnel.viewer-384", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
