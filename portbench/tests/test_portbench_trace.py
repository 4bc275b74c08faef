from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.trace import MARK, Trace


def _trace():
    # A 100 us slice: kernels at 10-20, 15-30 (overlapping), 60-70 and one
    # record outside the slice; host operations around the gaps.
    return Trace(0.0, 100.0,
                 device=[(10.0, 20.0, "k1"), (15.0, 30.0, "k2"),
                         (60.0, 70.0, "k1"), (150.0, 160.0, "k3")],
                 host=[(30.0, 60.0, MARK + "client json.loads"),
                       (0.0, 100.0, MARK + "client round trip /lbm/frame"),
                       (75.0, 95.0, "aten::copy_")])


def test_portbench_idle_share_from_a_synthetic_trace():
    t = _trace()
    assert t.busy_s == pytest.approx(30e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.idle_pct() == pytest.approx(70.0)
    assert t.device_ops() == [["k1", pytest.approx(20e-6)],
                              ["k2", pytest.approx(15e-6)]]
    gaps = t.idle_gaps()
    assert gaps[0] == ["client json.loads", pytest.approx(30e-6)]
    assert gaps[1] == ["aten::copy_", pytest.approx(30e-6)]
    assert gaps[2] == ["client round trip /lbm/frame", pytest.approx(10e-6)]


def test_portbench_idle_reader_and_missing_trace():
    reader = registry.load_module("layer_metrics", "device_idle_pct.frame")
    assert reader.read(SimpleNamespace(trace=_trace())) == \
        pytest.approx(70.0)
    assert reader.read(SimpleNamespace(trace=None)) is None
