"""``chip_smoke.py``'s measuring helpers and its refusal to run without a
card, on the CPU: the ptxas log parser behind the build phase's
local-memory bar, the bound of a call (bytes or operations), the operation
count of a plain version, the kernel phase's comparisons (through a stand-in
of the kernel module), and the exit without CUDA."""

import contextlib
import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke
from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.lbm import core, kernel, masks
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
    cell word once: 74 bytes a cell, over the memory rate."""
    ms, by = chip_smoke.lbm_bound(torch.device("cpu"), core, masks, LBMConfig,
                                  (64, 32))
    assert by == "bytes"
    assert ms == pytest.approx(74 * 64 * 32 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_word_bound_is_mask_and_word_bytes():
    """The cell word reads the float32 mask and writes a uint16 a cell."""
    ms, _ = chip_smoke.word_bound(torch.device("cpu"), core, masks, LBMConfig)
    cells = LBMConfig().nx * LBMConfig().ny
    assert ms >= 6 * cells / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_largest_resident_grid():
    """The largest 2:1 grid the resident kernel holds on an H100 is
    880x440; the next, 896x448, is past it."""
    class Card:
        device_limits = staticmethod(lambda dev: (132, 232_448))
        prefers_tiled = staticmethod(kernel.prefers_tiled)

    assert chip_smoke.largest_resident(Card, None) == (880, 440)
    assert kernel.prefers_tiled(448, 896, 132, 232_448)


def test_kernel_events_counts_device_kernels():
    class Event:
        def __init__(self, key, count, us):
            self.key, self.count, self.device_time_total = key, count, us

    class Prof:
        def key_averages(self):
            return [Event("void lbm_resident_kernel(float const*)", 1, 12.5),
                    Event("cell_word_kernel", 2, 3.0),
                    Event("aten::empty", 4, 0.0)]

    ev = chip_smoke.kernel_events(Prof(), "lbm_resident_kernel",
                                  "lbm_tiled_kernel")
    assert ev["lbm_resident_kernel"] == (1, 12.5)
    assert ev["lbm_tiled_kernel"] == (0, 0.0)
    assert ev["all"] == (3, 15.5)


class _StandInKernels:
    """The LBM kernel module's surface that ``phase_kernel`` reads, on the
    plain versions: counts like the wrappers, holds lattices up to
    ``capacity`` cells, and adds ``word_error`` to one cell's word."""

    def __init__(self, word_error=0, capacity=40 * 20):
        self.launches = self.word_launches = 0
        self.word_error, self.capacity = word_error, capacity

    def cell_word(self, solid):
        self.word_launches += 1
        word = core.cell_word(solid).to(torch.int32)
        word[1, 1] += self.word_error
        return word.to(torch.uint16)

    def lbm_steps(self, f, solid, u0, tau, steps=4, word=None):
        if f.shape[1] * f.shape[2] > self.capacity:
            raise ValueError("past capacity")
        self.launches += 1
        return core.lbm_step(f, solid, u0, tau, steps=steps)


def _rehearse_phase_kernel(monkeypatch, kern):
    class Event:
        key, count, device_time_total = "lbm_resident_kernel", 1, 10.0

    class Prof:
        def key_averages(self):
            return [Event()]

    monkeypatch.setattr(chip_smoke, "GRIDS", [(32, 16)])
    monkeypatch.setattr(chip_smoke, "TILED_GRIDS", [(24, 12)])
    monkeypatch.setattr(chip_smoke, "STEP_COUNTS", (1, 3))
    monkeypatch.setattr(chip_smoke, "PAST_CAPACITY", (64, 32))
    monkeypatch.setattr(chip_smoke, "traced", contextlib.contextmanager(
        lambda: (yield Prof())))
    monkeypatch.setattr(chip_smoke, "largest_resident",
                        lambda kernel, dev: (40, 20))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return chip_smoke.phase_kernel(torch.device("cpu"), kern, core, masks,
                                   LBMConfig)


@pytest.mark.parametrize("word_error", [0, 2])
def test_phase_kernel_reports_the_word_difference_it_measured(
        monkeypatch, word_error):
    """The kernel phase's cell-word error is the difference it measured
    against the plain word, and any difference fails the phase."""
    kern = _StandInKernels(word_error)
    if word_error:
        with pytest.raises(RuntimeError, match="cell_word != plain"):
            _rehearse_phase_kernel(monkeypatch, kern)
        return
    step_err, word_err = _rehearse_phase_kernel(monkeypatch, kern)
    assert word_err == 0.0 and 0.0 <= step_err <= chip_smoke.ATOL
    assert kern.word_launches == 5 and kern.launches == 1 + 2


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
