from types import SimpleNamespace

import pytest

from portbench import peaks, registry

CFG = registry.load_json("configs", "aerolab-wind-tunnel")


def test_portbench_lbm_bytes_and_ops_frozen_at_384x192():
    """The bound's counts against a hand count: a cell's call moves its 9
    float32 populations in and out once (72 B) and reads its uint16 word
    (2 B); the plain step's 201 float32 operations a cell."""
    lat = CFG["lattice"]
    cells = lat["nx"] * lat["ny"]
    assert cells == 73_728
    assert peaks.lbm_call_bytes(lat["nx"], lat["ny"]) == 74 * cells \
        == 5_455_872
    reference = registry.load_module("configs", "aerolab-wind-tunnel")
    assert peaks.lbm_step_ops(reference, lat) == 201 * cells == 14_819_328
    reader = registry.load_module("layer_metrics",
                                  "lbm_steps_roofline_pct.tunnel")
    assert (reader.BYTES_PER_CELL, reader.OPS_PER_CELL_STEP) == (74, 201)
    bound = peaks.bound_s(5_455_872, 4 * 14_819_328)
    assert bound == pytest.approx(5_455_872 / 3.35e12)      # bytes bound it


def test_portbench_roofline_reader():
    reader = registry.load_module("layer_metrics",
                                  "lbm_steps_roofline_pct.tunnel")
    bound_us = 5_455_872 / 3.35e12 * 1e6
    trace = SimpleNamespace(kernel_us=lambda part: [2 * bound_us,
                                                    2 * bound_us])
    ctx = SimpleNamespace(trace=trace, config=CFG)
    assert reader.read(ctx) == pytest.approx(50.0)
    ctx.trace = SimpleNamespace(kernel_us=lambda part: [])
    assert reader.read(ctx) is None
