"""The comparison that decides ``correct``: it accepts the program and the
float32 reference, and rejects the bfloat16 control and a run whose timed
path is broken underneath (a step that leaves the lattice unchanged, a
frame's answer altered where it is produced)."""

import pytest
import torch

from portbench import control, run

CELL = "tunnel.viewer-384"


def _rejected(checks):
    return any(c["value"] > c["limit"] for c in checks.values())


def test_portbench_control_rejected_float32_accepted():
    dev = torch.device("cpu")
    assert _rejected(control.control(CELL, 11, 40, dev))       # bfloat16
    assert not _rejected(control.control(CELL, 11, 40, dev, torch.float32))


def _cpu_run(tmp_path, monkeypatch, seed=2 ** 31 + 101):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    result, _ = run.run(CELL, seed, 3.0, False, torch.device("cpu"))
    assert result["attempted"] >= 3 and result["failed"] == 0
    return result


def test_portbench_sound_cpu_run_is_correct(tmp_path, monkeypatch):
    assert _cpu_run(tmp_path, monkeypatch)["correct"]


def test_portbench_state_left_unchanged_is_not_correct(tmp_path,
                                                        monkeypatch):
    from airfoil_tpu_torch.lbm import runner
    monkeypatch.setattr(runner, "lbm_steps", lambda f, *a, **k: f)
    assert not _cpu_run(tmp_path, monkeypatch)["correct"]


def test_portbench_altered_answer_is_not_correct(tmp_path, monkeypatch):
    from airfoil_tpu_torch.lbm import runner
    frame = runner.WindTunnel.frame

    def altered(self, *a, **k):
        out = frame(self, *a, **k)
        speed = out["fields"]["speed"].clone()
        speed[96, 370] += 0.1                 # one fluid cell, 10 % of U0
        out["fields"]["speed"] = speed
        return out

    monkeypatch.setattr(runner.WindTunnel, "frame", altered)
    assert not _cpu_run(tmp_path, monkeypatch)["correct"]


@pytest.mark.card
def test_portbench_control_rejected_on_the_card_at_the_cell_size():
    """The control at the cell's own size: as many frames as a run's
    window serves, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        assert _rejected(control.control(CELL, seed, 3300,
                                         torch.device("cuda")))
