"""The per-layer metrics that read the program's own spans from the traced
slice, on a hand-made trace: device intervals placed by hand, and host
spans of three frames (one after the slice, one across its start), of a
set-up reply whose ``http.encode`` lies outside every frame, and of torch
operations."""

from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.trace import MARK, Trace

READERS = ("server_ms.frame", "encode_ms.frame", "fields_ms.frame",
           "tunnel_frame_ms.frame", "idle_in_server_pct.frame")


def _trace(host=None):
    # A 1,000 us slice from 1,000 to 2,000; busy 1,000-1,010 (a record
    # begun before the slice), 1,100-1,150, 1,300-1,320 and 1,700-1,800;
    # idle 1,010-1,100, 1,150-1,300, 1,320-1,700 and 1,800-2,000: 820 us.
    device = [(900.0, 1010.0, "k0"), (1100.0, 1150.0, "lbm_resident_kernel"),
              (1300.0, 1320.0, "Memcpy DtoH"), (1700.0, 1800.0, "k1"),
              (2100.0, 2200.0, "k2")]
    if host is None:
        host = [
            # A frame across the slice's start.
            (800.0, 1040.0, "http /lbm/frame"),
            (900.0, 1000.0, "http.encode"),
            # Two frames inside the slice.
            (1050.0, 1400.0, "http /lbm/frame"),
            (1050.0, 1080.0, "http.read"),
            (1080.0, 1090.0, "lbm.wait"),
            (1090.0, 1200.0, "lbm.frame"),
            (1095.0, 1110.0, "lbm.step"),
            (1110.0, 1190.0, "lbm.diagnostics"),
            (1200.0, 1330.0, "lbm.fields"),
            (1330.0, 1380.0, "http.encode"),
            (1380.0, 1400.0, "http.write"),
            (1410.0, 1495.0, "http /lbm/start"),
            (1420.0, 1490.0, "http.encode"),
            (1500.0, 1900.0, "http /lbm/frame"),
            (1510.0, 1560.0, "lbm.frame"),
            (1600.0, 1700.0, "lbm.fields"),
            (1800.0, 1860.0, "http.encode"),
            (1000.0, 2000.0, MARK + "client round trip /lbm/frame"),
            (1120.0, 1130.0, "aten::copy_"),
            # A frame after the slice.
            (2100.0, 2500.0, "http /lbm/frame"),
            (2110.0, 2140.0, "lbm.frame"),
            (2150.0, 2200.0, "lbm.fields"),
            (2300.0, 2400.0, "http.encode"),
        ]
    return Trace(1000.0, 2000.0, device=device, host=host)


EXPECTED = {
    "server_ms.frame": 0.375,          # 350 and 400 us
    "encode_ms.frame": 0.055,          # 50 and 60 us; not the set-up's 70
    "fields_ms.frame": 0.115,          # 130 and 100 us
    "tunnel_frame_ms.frame": 0.080,    # 110 and 50 us
    # Of the 820 us idle: 30 (the frame across the start, cut to it) + 50
    # + 150 + 80 (the first frame) + 200 + 100 (the second).
    "idle_in_server_pct.frame": 100.0 * 610.0 / 820.0,
}


@pytest.mark.parametrize("name", READERS)
def test_portbench_span_reader_on_a_synthetic_trace(name):
    reader = registry.load_module("layer_metrics", name)
    assert reader.read(SimpleNamespace(trace=_trace())) == \
        pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_portbench_span_reader_none_without_trace_or_spans(name):
    """No trace, or a program without spans (the parent of the spans):
    the metric is left out."""
    reader = registry.load_module("layer_metrics", name)
    assert reader.read(SimpleNamespace(trace=None)) is None
    bare = _trace(host=[(1000.0, 2000.0, MARK + "client round trip "
                         "/lbm/frame"), (1120.0, 1130.0, "aten::copy_")])
    assert reader.read(SimpleNamespace(trace=bare)) is None


def test_portbench_span_readers_registered():
    """Each reader has its entry under ``per_layer``, read in the viewer's
    cell and moving its rate."""
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    reported = {m["name"] for m in registry.metrics_for(
        bench, "per_layer", "tunnel.viewer-384")}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["tunnel.viewer-384"]
        assert m["moves"] == "tunnel_mlups"
        assert m["source"] == ("device_trace" if name.endswith("pct.frame")
                               else "program_span")
        assert name in reported
        assert callable(registry.load_module("layer_metrics", name).read)
