"""``chip_smoke.py``'s measuring helpers and its refusal to run without a
card, on the CPU: the ptxas log parser behind the build phase's
local-memory bar, the bound of a call (bytes or operations), the operation
count of a plain version, and the exit without CUDA."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke
from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.lbm import core, masks
from airfoil_tpu_torch.viscous import march

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__f2b5110d_11_bl_march_cu_7f5ef0eb17march_wake_kernelEPKfS1_S1_S1_S1_S1_PfS2_S2_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__f2b5110d_11_bl_march_cu_7f5ef0eb17march_wake_kernelEPKfS1_S1_S1_S1_S1_PfS2_S2_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__03ff5d18_11_bl_march_cu_7f5ef0eb17march_side_kernelEPKfS1_S1_S1_S1_S1_NS_7SideOutEii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__03ff5d18_11_bl_march_cu_7f5ef0eb17march_side_kernelEPKfS1_S1_S1_S1_S1_NS_7SideOutEii
    96 bytes stack frame, 0 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 95 registers, used 0 barriers, 96 bytes cumulative stack size
"""


def test_ptxas_usage():
    assert chip_smoke.ptxas_usage(PTXAS_LOG) == {
        "march_wake_kernel": {"stack": 0, "spill_stores": 0,
                              "spill_loads": 0, "registers": 63},
        "march_side_kernel": {"stack": 96, "spill_stores": 0,
                              "spill_loads": 4, "registers": 95}}


@pytest.mark.parametrize("mangled, name", [
    ("_ZN44_GLOBAL__N__03ff5d18_11_bl_march_cu_7f5ef0eb17march_side_kernel"
     "EPKfS1_S1_S1_S1_S1_NS_7SideOutEii", "march_side_kernel"),
    ("_ZN44_GLOBAL__N__f2b5110d_11_bl_march_cu_7f5ef0eb17march_wake_kernel"
     "EPKfS1_S1_S1_S1_S1_PfS2_S2_ii", "march_wake_kernel"),
    ("_Z15lbm_step_kernelPKfPfPKhii14LbmParams", "lbm_step_kernel"),
    ("_Z4mainv", "_Z4mainv")])
def test_kernel_name(mangled, name):
    """The build phase names each kernel by its function."""
    assert chip_smoke.kernel_name(mangled) == name


@pytest.mark.parametrize("moved, ops, by", [(3.35e9, 1.0, "bytes"),
                                            (1.0, 67e9, "operations")])
def test_bound(moved, ops, by):
    ms, what = chip_smoke.bound(moved, ops)
    assert what == by and ms == pytest.approx(1.0)


def test_count_ops():
    x = torch.ones(10)
    assert chip_smoke.count_ops(lambda a: torch.exp(a * 2.0 + a), x) == 30
    assert chip_smoke.nbytes(x, x.bool()) == 50


def test_lbm_bound_is_the_lattice_bytes():
    """A 4-step call at the served grid moves the lattice twice and the
    mask once: 76 bytes a cell, over the memory rate."""
    ms, by = chip_smoke.lbm_bound(torch.device("cpu"), core, masks, LBMConfig,
                                  (64, 32))
    assert by == "bytes"
    assert ms == pytest.approx(76 * 64 * 32 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_plain_march_ops_are_the_same_every_interval():
    """The side bound scales the plain march's count over a few intervals
    to the call's: every interval must count the same."""
    s = torch.linspace(0.004, 0.3, 6).expand(2, -1).contiguous()
    ue = torch.stack([torch.ones(6), torch.linspace(1.0, 1.2, 6)])
    counts = [chip_smoke.count_ops(march.march_side, s[:, :k], ue[:, :k],
                                   s[:, :k], 1e-6) for k in (3, 4, 5, 6)]
    steps = {b - a for a, b in zip(counts, counts[1:])}
    assert len(steps) == 1 and steps.pop() > 0


@pytest.mark.parametrize("alone", [False, True])
def test_exits_without_a_card(tmp_path, alone):
    """No CUDA device here: the script fails and prints no result line,
    from the checkout and from a directory holding only the script."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
