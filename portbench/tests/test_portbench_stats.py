from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.stats import percentile, window_bounds


def test_portbench_percentile_nearest_rank():
    values = list(range(1, 101))          # 1..100
    assert percentile(values, 95) == 95
    assert percentile(values, 90) == 90
    assert percentile(values, 100) == 100
    assert percentile([3.0], 95) == 3.0
    assert percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        percentile([], 95)


def _rec(route, sent, received, step, client=0):
    return SimpleNamespace(route=route, sent=sent, received=received,
                           seconds=received - sent, client=client,
                           reply=None if step is None else {"step": step})


def test_portbench_window_closes_at_the_last_reply():
    recs = [_rec("/lbm/frame", 10.0 + k, 10.5 + k, 4 * (k + 1))
            for k in range(20)]
    assert window_bounds([(r.sent, r.received) for r in recs]) == (10.0, 29.5)


def test_portbench_frame_p95_and_mlups_over_all_requests():
    recs = [_rec("/lbm/frame", k, k + 0.001 * (k + 1), 4 * (k + 1))
            for k in range(100)]
    recs.append(_rec("/lbm/stop", 200, 201, None))
    cfg = {"lattice": {"nx": 384, "ny": 192, "steps_per_frame": 4}}
    ctx = SimpleNamespace(requests=recs, config=cfg, window_s=50.0)
    p95 = registry.load_module("layer_metrics",
                               "round_trip_p95_ms.frame").read(ctx)
    assert p95 == pytest.approx(95.0)
    mlups = registry.load_module("end_to_end", "tunnel_mlups").read(ctx)
    assert mlups == pytest.approx(384 * 192 * 400 / 50.0 / 1e6)
    ctx.requests = []
    assert registry.load_module("layer_metrics",
                                "round_trip_p95_ms.frame").read(ctx) is None


def test_portbench_mlups_sums_each_session():
    """Two viewers, each on its own session: each session's steps count
    from the step before its first frame of the window."""
    recs = [_rec("/lbm/frame", k, k + 0.01, 400 + 4 * k, client=0)
            for k in range(10)]
    recs += [_rec("/lbm/frame", k, k + 0.02, 8 + 4 * k, client=1)
             for k in range(5)]
    cfg = {"lattice": {"nx": 384, "ny": 192, "steps_per_frame": 4}}
    ctx = SimpleNamespace(requests=recs, config=cfg, window_s=10.0)
    mlups = registry.load_module("end_to_end", "tunnel_mlups").read(ctx)
    assert mlups == pytest.approx(384 * 192 * (40 + 20) / 10.0 / 1e6)


def test_portbench_handler_median_reader():
    ctx = SimpleNamespace(spans={"LBMSessions.frame": [(0, 0.001), (1, 1.003),
                                                      (2, 2.002)]})
    got = registry.load_module("layer_metrics", "handler_ms.frame").read(ctx)
    assert got == pytest.approx(2.0)
    ctx.spans = {}
    assert registry.load_module("layer_metrics",
                                "handler_ms.frame").read(ctx) is None
