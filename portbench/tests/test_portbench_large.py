"""The cell ``tunnel.large-2048``: its files found by name, the tiled
kernel's frozen counts and readers, the plain reference's early exit where
the session served is not the configuration's, and its comparison on a
small lattice (the float32 reference passes, the bfloat16 control fails);
the control at the cell's own size is marked ``card``."""

import json
import random
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, peaks, registry, run, traffic

CELL = "tunnel.large-2048"
CONFIG = "aerolab-tunnel-2048"


def _rejected(checks):
    return any(c["value"] > c["limit"] for c in checks.values())


def test_portbench_large_cell_found_from_its_files():
    bench = registry.benchmark()
    spec = registry.cell(bench, CELL)
    assert (spec["config"], spec["traffic"], spec["chips"]) == \
        (CONFIG, "large-slider", 1)
    cfg = spec["config_file"]
    assert cfg["name"] == CONFIG and cfg["reduced"] == []
    lat = cfg["lattice"]
    assert (lat["nx"], lat["ny"], lat["steps_per_frame"]) == (2048, 1024, 24)
    assert (cfg["precision"], cfg["control_precision"]) == \
        ("float32", "bfloat16")
    assert spec["mix"] == registry.load_json("traffic", "large-slider")
    for req in spec["mix"]["warmup"] + spec["mix"]["setup"]:
        if req["route"] == "/lbm/start":
            assert req["fields"]["nx"] == lat["nx"]
    # A server that does not say its session's steps a frame (one that
    # cannot open this lattice) fails the warm-up's first request.
    assert spec["mix"]["warmup"][0]["bind"] == ["session", "steps_per_frame"]
    for label in ("lbm_launches", "lbm_tiled_launches"):
        owner, name = run.resolve(spec["counters"][label])
        assert isinstance(getattr(owner, name), int)
    assert set(run.counter_values(spec["counters"])) == set(spec["counters"])
    e2e = [m["name"] for m in registry.metrics_for(bench, "end_to_end", CELL)]
    assert e2e == ["setup_s", "tunnel_mlups"]
    layer = [m["name"] for m in registry.metrics_for(bench, "per_layer",
                                                     CELL)]
    assert layer == ["lbm_tiled_roofline_pct.tunnel",
                     "tiled_update_pct.tunnel"]
    for name in layer:
        registry.load_module("layer_metrics", name)
    reference = registry.load_module("configs", CONFIG)
    assert callable(reference.numbers) and callable(reference.served)


def test_portbench_large_plan_is_the_same_for_a_seed():
    mix = registry.load_json("traffic", "large-slider")
    a, b = (traffic.plan(mix, 2 ** 31 + 77) for _ in range(2))
    take = [[r.fields for r in (next(p.clients[0].window)
                                for _ in range(200))] for p in (a, b)]
    assert take[0] == take[1]
    alphas = [float(f["alpha"]) for f in take[0]]
    moves = [k for k in range(1, 200) if alphas[k] != alphas[k - 1]]
    assert moves == [60, 120, 180]
    assert all(f["fields"] == "speed" for f in take[0])
    assert [r.fields["nx"] for r in a.clients[0].setup] == ["2048"]


def test_portbench_tiled_counts_frozen_at_2048x1024():
    """74 B a cell for the call and 201 float32 operations a cell-step: at
    2048x1024 and 24 steps the bound is 151.0 us, set by the operations."""
    reader = registry.load_module("layer_metrics",
                                  "lbm_tiled_roofline_pct.tunnel")
    assert (reader.BYTES_PER_CELL, reader.OPS_PER_CELL_STEP) == (74, 201)
    cells = 2048 * 1024
    assert peaks.lbm_call_bytes(2048, 1024) == 74 * cells == 155_189_248
    ops = 201 * cells * 24
    assert ops == 10_116_661_248
    assert 1e6 * 155_189_248 / peaks.HBM_BYTES_PER_S == \
        pytest.approx(46.3, abs=0.05)
    assert 1e6 * peaks.bound_s(155_189_248, ops) == \
        pytest.approx(151.0, abs=0.05)
    assert peaks.bound_s(155_189_248, ops) == ops / peaks.F32_OPS_PER_S


def test_portbench_tiled_roofline_reader():
    """The bound of a call over a call's device time: the kernel's launches
    over the ``lbm.step`` spans (6 launches a 24-step call)."""
    reader = registry.load_module("layer_metrics",
                                  "lbm_tiled_roofline_pct.tunnel")
    cfg = registry.load_json("configs", CONFIG)
    bound_us = 201 * 2048 * 1024 * 24 / peaks.F32_OPS_PER_S * 1e6
    launch_us = bound_us / 6 / 0.25          # a call at 25 % of its bound
    host = [(0, 1, "lbm.step"), (5, 6, "lbm.step"), (2, 3, "lbm.frame")]
    trace = SimpleNamespace(kernel_us=lambda part: [launch_us] * 12,
                            host=host)
    ctx = SimpleNamespace(trace=trace, config=cfg)
    assert reader.read(ctx) == pytest.approx(25.0)
    ctx.trace = SimpleNamespace(kernel_us=lambda part: [], host=host)
    assert reader.read(ctx) is None
    ctx.trace = SimpleNamespace(kernel_us=lambda part: [launch_us], host=[])
    assert reader.read(ctx) is None
    assert reader.read(SimpleNamespace(trace=None, config=cfg)) is None


def test_portbench_tiled_update_reader():
    reader = registry.load_module("layer_metrics", "tiled_update_pct.tunnel")

    def read(**counters):
        return reader.read(SimpleNamespace(counters=counters))

    assert read(lbm_tiled_launches=300, lbm_launches=0) == 100.0
    assert read(lbm_tiled_launches=300, lbm_launches=100) == 75.0
    assert read(lbm_tiled_launches=0, lbm_launches=0) is None
    assert read(lbm_launches=4) is None


def _record(route, fields, reply, files=None):
    return SimpleNamespace(route=route, fields=fields, files=files or {},
                           reply=reply)


def _session(mix_seed, grid, frames, keep_fields, step_of=None):
    """A client's records as a run keeps them: the set-up's start (with
    its reply's ``grid``) and ``frames`` window frames, those in
    ``keep_fields`` with a ``speed`` field; ``step_of(k)`` gives frame k's
    ``step``."""
    plan = traffic.plan(registry.load_json("traffic", "large-slider"),
                        mix_seed)
    start = plan.clients[0].setup[0]
    setup = [_record(start.route, start.fields, {"grid": grid}, start.files)]
    window = []
    for k in range(frames):
        req = next(plan.clients[0].window)
        reply = {"cl": 0.5, "cd": 0.05, "separation": 0.0,
                 "step": step_of(k) if step_of else 4 * (k + 1),
                 "alpha": float(req.fields["alpha"]), "outline": []}
        if k in keep_fields:
            reply["fields"] = {"speed": {"shape": grid, "dtype": "float32",
                                         "data": ""}}
        window.append(_record(req.route, req.fields, reply))
    return SimpleNamespace(setup=setup, window=window)


def _counting_steps(reference, monkeypatch) -> list:
    """Count the steps of the reference's tunnel."""
    steps = []
    step = reference.Tunnel.step

    def counted(self):
        steps.append(1)
        return step(self)

    monkeypatch.setattr(reference.Tunnel, "step", counted)
    return steps


def test_portbench_large_reference_stops_on_a_wrong_grid(monkeypatch):
    """A session at the viewer's 384 x 192 (a program that ignores ``nx``):
    every frame and every cell of the kept fields wrong, at once and
    without a step."""
    reference = registry.load_module("configs", CONFIG)
    steps = _counting_steps(reference, monkeypatch)
    cfg = registry.load_json("configs", CONFIG)
    client = _session(2 ** 31 + 5, [192, 384], 10_000, {3, 500, 9_999})
    t0 = time.perf_counter()
    out = reference.numbers([client], cfg, torch.device("cpu"))
    assert time.perf_counter() - t0 < 1.0
    assert steps == []
    assert out["step_or_alpha_wrong"] == 10_000
    assert out["body_cells_wrong"] == 3 * 2048 * 1024
    checks = {k: {"value": v, "limit": cfg["limits"][k]}
              for k, v in out.items()}
    assert _rejected(checks)


def test_portbench_large_reference_stops_at_the_first_wrong_step(
        monkeypatch):
    """The right grid but 4 steps a frame, not 24: the first frame's step
    differs, and it and the rest count wrong; the reference steps that one
    frame, not the 5,000."""
    reference = registry.load_module("configs", CONFIG)
    steps = _counting_steps(reference, monkeypatch)
    cfg = registry.load_json("configs", CONFIG)
    cfg = dict(cfg, lattice=dict(cfg["lattice"], nx=128, ny=64))
    client = _session(2 ** 31 + 6, [64, 128], 5_000, set())
    out = reference.numbers([client], cfg, torch.device("cpu"))
    assert len(steps) == cfg["lattice"]["steps_per_frame"] == 24
    assert out["step_or_alpha_wrong"] == 5_000


def _small_control(seed, frames, dtype):
    """``control.control`` of the cell on a 128 x 64 lattice on the CPU:
    the reference in ``dtype`` served in the program's place, judged by the
    float64 reference."""
    spec = registry.cell(registry.benchmark(), CELL)
    cfg = spec["config_file"]
    cfg = dict(cfg, lattice=dict(cfg["lattice"], nx=128, ny=64))
    reference = registry.load_module("configs", CONFIG)
    plan = traffic.plan(spec["mix"], seed)
    requests = [next(plan.clients[0].window) for _ in range(frames)]
    keep = set(random.Random(seed).sample(range(frames), 6)) | {frames - 1}
    setup = [SimpleNamespace(route=r.route, fields=r.fields, files=r.files)
             for r in plan.clients[0].setup]
    window = reference.served(setup, requests, keep, cfg,
                              torch.device("cpu"), dtype)
    assert all(set(f.reply.get("fields", {"speed": 0})) == {"speed"}
               for f in window)
    readings = reference.numbers(
        [SimpleNamespace(setup=setup, window=window)], cfg,
        torch.device("cpu"))
    return {k: {"value": v, "limit": cfg["limits"][k]}
            for k, v in readings.items()}


def test_portbench_large_float32_passes_bfloat16_control_fails():
    seed = 2 ** 31 + 9
    assert not _rejected(_small_control(seed, 30, torch.float32))
    assert _rejected(_small_control(seed, 30, torch.bfloat16))


@pytest.mark.card
def test_portbench_large_control_rejected_on_the_card_at_the_cell_size():
    """The control at the cell's own size: as many frames as a run's
    window serves, on two seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 11, 2 ** 31 + 12):
        checks = control.control(CELL, seed, 850, torch.device("cuda"))
        assert _rejected(checks), json.dumps(checks)
