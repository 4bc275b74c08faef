import itertools

import numpy as np
import pytest

from portbench import registry, traffic

NACA4 = registry.load_module("airfoils", "naca4")


def _mix():
    return registry.load_json("traffic", "viewer-slider")


def _alphas(plan, n):
    return [float(r.fields["alpha"])
            for r in itertools.islice(plan.window, n)]


def test_portbench_viewer_mix_is_deterministic_by_seed():
    mix = _mix()
    a, b = traffic.plan(mix, 2 ** 31 + 17), traffic.plan(mix, 2 ** 31 + 17)
    pa, pb = a.clients[0], b.clients[0]
    assert [(r.fields, r.files) for r in pa.setup] == \
        [(r.fields, r.files) for r in pb.setup]
    assert _alphas(pa, 600) == _alphas(pb, 600)
    assert [(r.fields, r.files) for r in a.warmup] == \
        [(r.fields, r.files) for r in b.warmup]
    other = traffic.plan(mix, 2 ** 31 + 18)
    assert [(r.fields, r.files) for r in other.warmup] == \
        [(r.fields, r.files) for r in a.warmup]      # the warm-up is fixed


def test_portbench_viewer_mix_same_work_for_every_seed():
    """Seeds change the airfoil and the slider's path, never the amount of
    work: the same grid, points, fields and one move every 60 frames."""
    mix = _mix()
    texts = set()
    for seed in (1, 2, 3, 4, 5, 6, 3_000_000_007):
        t = traffic.plan(mix, seed)
        assert t.arrival == {"kind": "closed", "clients": 1}
        assert t.arrivals is None and len(t.clients) == 1
        plan = t.clients[0]
        alphas = _alphas(plan, 1200)
        start, = plan.setup
        assert start.route == "/lbm/start" and start.bind == ("session",)
        assert alphas[0] == float(start.fields["alpha"]) == 6.0
        text = start.files["file"][1].decode()
        texts.add(text)
        moves = [k for k in range(1, len(alphas))
                 if alphas[k] != alphas[k - 1]]
        assert moves == list(range(60, 1200, 60))
        spec = mix["values"]["alpha"]["slider"]
        lo, hi = spec["range"]
        assert all(lo <= a <= hi for a in alphas)
        assert all(abs(alphas[k] - alphas[k - 1]) in spec["steps"]
                   for k in moves)
        lines = text.strip().splitlines()
        assert len(lines) == 1 + 2 * mix["files"]["body"]["points_per_side"] \
            - 1
        req = next(iter(plan.window))
        assert req.fields["fields"] == "speed,ux,uy"
        assert req.fields["session"] == "{session}"
        assert req.fields["u0"] == "0.06"
        assert len(t.warmup) == 24 + 2
        assert [r.route for r in plan.close] == ["/lbm/stop"]
    assert len(texts) > 1


def test_portbench_slider_turns_back_at_its_ends():
    spec = {"start": 2.0, "every": 1, "steps": [2.0], "range": [-1.0, 3.0]}
    alphas = list(itertools.islice(
        traffic.slider(spec, np.random.default_rng(0)), 200))
    assert all(-1.0 <= a <= 3.0 for a in alphas)


def test_portbench_naca4_selig_order():
    c = NACA4.naca4(0.02, 0.4, 0.12, 100)
    assert c.shape == (199, 2)
    assert c[0, 0] > 0.99 and c[-1, 0] > 0.99
    assert (c[99] == 0.0).all()                       # the nose
    le = c[:, 0].argmin()          # the parser's winding test: upper first
    assert c[le - 1, 1] > 0


UPLOADS = {
    "arrival": {"kind": "closed", "clients": 2},
    "block": 12,
    "files": {"body": {"maker": "naca4", "camber_pct": [0, 6],
                       "camber_pos": [2, 6], "thickness_pct": [8, 18],
                       "points_per_side": 60, "per": "request"},
              "fixed": {"maker": "naca4", "camber_pct": [2, 2],
                        "camber_pos": [4, 4], "thickness_pct": [12, 12],
                        "points_per_side": 100}},
    "values": {"alpha": {"strata": [-10, 20], "grid": 0.5},
               "re": {"each": [5e4, 2e5, 5e5, 1e6, 3e6, 6e6]},
               "off": {"uniform": [0.0, 0.01]},
               "alpha_start": {"add": [-10, "off"]},
               "alpha_end": {"add": [20, "off"]}},
    "window": [{"route": "/upload_airfoil/", "files": {"file": "body"},
                "fields": {"alpha": "{alpha}", "reynolds": "{re}"}},
               {"route": "/polar/", "files": {"file": "fixed"},
                "fields": {"alpha_start": "{alpha_start}",
                           "alpha_end": "{alpha_end}", "alpha_step": 1.0,
                           "reynolds": 1000000}}],
}


def test_portbench_stratified_blocks_for_every_seed():
    """Every block of 12 requests takes one angle from each 2.5-degree
    stratum of -10..20 on the 0.5-degree grid and each Reynolds number
    twice, in an order the seed shuffles."""
    orders = set()
    for seed in (7, 8, 2 ** 31 + 9):
        for plan in traffic.plan(UPLOADS, seed).clients:
            reqs = [r for r in itertools.islice(plan.window, 96)
                    if r.route == "/upload_airfoil/"]
            assert len(reqs) == 48
            for b in range(4):
                block = reqs[12 * b:12 * b + 12]
                alphas = [float(r.fields["alpha"]) for r in block]
                assert sorted(min(int((a + 10) // 2.5), 11)
                              for a in alphas) == \
                    list(range(12))
                assert all(a * 2 == round(a * 2) for a in alphas)
                res = [float(r.fields["reynolds"]) for r in block]
                assert sorted(res) == sorted(
                    UPLOADS["values"]["re"]["each"] * 2)
                orders.add(tuple(alphas))
            assert len({r.files["file"][1] for r in reqs}) > 1   # per request
    assert len(orders) > 4


def test_portbench_added_values_share_one_draw_and_clients_differ():
    t = traffic.plan(UPLOADS, 2 ** 31 + 3)
    polars = [[r for r in itertools.islice(p.window, 20)
               if r.route == "/polar/"] for p in t.clients]
    for r in polars[0]:
        start, end = float(r.fields["alpha_start"]), float(
            r.fields["alpha_end"])
        assert 0 <= start + 10 < 0.01 and end - start == pytest.approx(30)
        assert r.fields["reynolds"] == "1000000"
        assert r.fields["alpha_step"] == "1.0"
    assert len({r.files["file"] for p in polars for r in p}) == 1   # fixed
    assert [r.fields for r in polars[0]] != [r.fields for r in polars[1]]
    again = traffic.plan(UPLOADS, 2 ** 31 + 3)
    assert [r.fields for r in itertools.islice(again.clients[1].window, 20)
            if r.route == "/polar/"] == [r.fields for r in polars[1]]


def test_portbench_open_loop_offers_the_same_load_for_every_seed():
    spec = {"kind": "open", "rate_per_s": 4.0, "bursts": [1, 1, 2, 4],
            "block": 8, "connections": 3}
    mix = {"arrival": spec, "window": [{"route": "/x", "fields": {}}]}
    per_seed = []
    for seed in (1, 2, 2 ** 31 + 5):
        t = traffic.plan(mix, seed)
        assert len(t.clients) == 1
        times = list(itertools.islice(t.arrivals, 4000))
        assert times == sorted(times)
        per_seed.append(times)
        # 16 requests (8 bursts: sizes 1, 1, 2, 4 twice) a block.
        sizes = [len(list(g)) for _, g in itertools.groupby(times)]
        assert sorted(sizes[:8]) == [1, 1, 1, 1, 2, 2, 4, 4]
        end_of_block = times[15]
        assert sorted(sizes[8:16]) == [1, 1, 1, 1, 2, 2, 4, 4]
        assert 16 / times[15] == pytest.approx(4.0)
        assert end_of_block == pytest.approx(per_seed[0][15])
    assert per_seed[0][:16] != per_seed[1][:16]


def test_portbench_unknown_entries_are_refused():
    with pytest.raises(ValueError):
        traffic.plan({"arrival": {"kind": "sometimes"}, "window": []}, 1)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        next(traffic.stream({"each": [1, 2, 3]}, rng, 4))
    with pytest.raises(ValueError):
        next(traffic.stream({"normal": [0, 1]}, rng, 1))
