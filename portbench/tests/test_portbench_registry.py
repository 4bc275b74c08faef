import json
import os
import shutil

import pytest
import torch

from portbench import registry


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_portbench_dummy_cell_found_from_files_alone(tmp_path):
    base = str(tmp_path)
    _write(f"{base}/workloads/dummy.cell.json", json.dumps({"sample": {}}))
    _write(f"{base}/configs/dummy-config.json", json.dumps({"limits": {}}))
    _write(f"{base}/traffic/dummy-mix.json", json.dumps({"kind": "x"}))
    _write(f"{base}/end_to_end/dummy_rate.py",
           "def read(ctx):\n    return 2 * ctx\n")
    _write(f"{base}/layer_metrics/dummy_share.cell.py",
           "def read(ctx):\n    return None\n")
    bench = {
        "workloads": [{"name": "other", "config": "c", "traffic": "t",
                       "chips": 1},
                      {"name": "dummy.cell", "config": "dummy-config",
                       "traffic": "dummy-mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s"},
                       {"name": "dummy_rate", "workloads": ["dummy.cell"]},
                       {"name": "elsewhere", "workloads": ["other"]}],
        "per_layer": [{"name": "dummy_share.cell",
                       "workloads": ["dummy.cell"]}],
    }
    spec = registry.cell(bench, "dummy.cell", base)
    assert spec["mix"] == {"kind": "x"}
    assert spec["config_file"] == {"limits": {}}
    assert spec["chips"] == 1 and spec["sample"] == {}
    names = [m["name"] for m in registry.metrics_for(bench, "end_to_end",
                                                     "dummy.cell")]
    assert names == ["setup_s", "dummy_rate"]
    assert registry.load_module("end_to_end", "dummy_rate", base).read(4) == 8
    assert registry.load_module("layer_metrics", "dummy_share.cell",
                                base).read(None) is None
    with pytest.raises(KeyError):
        registry.cell(bench, "absent", base)


def test_portbench_every_entry_has_its_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        spec = registry.cell(bench, w["name"])
        assert set(spec["config_file"]["limits"])
        registry.load_module("configs", w["config"])
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s":
            assert callable(registry.load_module("end_to_end",
                                                 m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(registry.load_module("layer_metrics",
                                             m["name"]).read)


def _copy(src, dst):
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copyfile(src, dst)


def _cell_from_files(tmp_path, monkeypatch, mix, config, reference,
                     cell_spec=None, cell="dummy.cell"):
    """A benchmark of one cell written as files under ``tmp_path`` (the
    configuration's reference is ``reference``'s source), and the
    ``BENCHMARK.json`` entries that name them."""
    base = str(tmp_path / "bench")
    here = registry.HERE
    _write(f"{base}/workloads/{cell}.json", json.dumps(
        cell_spec or registry.load_json("workloads", "tunnel.viewer-384")))
    _write(f"{base}/configs/dummy-config.json", json.dumps(config))
    _write(f"{base}/configs/dummy-config.py", reference)
    _write(f"{base}/traffic/dummy-mix.json", json.dumps(mix))
    _copy(f"{here}/end_to_end/tunnel_mlups.py",
          f"{base}/end_to_end/tunnel_mlups.py")
    _write(f"{base}/end_to_end/requests_per_s.py",
           "def read(ctx):\n    return len(ctx.requests) / ctx.window_s\n")
    bench = {
        "workloads": [{"name": cell, "config": "dummy-config",
                       "traffic": "dummy-mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "tunnel_mlups", "unit": "MLUPS"},
                       {"name": "requests_per_s", "unit": "1/s"}],
        "per_layer": [],
    }
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    return bench, base


def test_portbench_two_viewers_cell_runs_from_files_alone(tmp_path,
                                                          monkeypatch):
    """A cell of two concurrent viewers, each on a session of its own, is
    data only: a mix with two closed-loop clients on the tunnel's own
    configuration and reference. The reference follows both sessions."""
    from portbench import run

    mix = registry.load_json("traffic", "viewer-slider")
    mix["arrival"] = {"kind": "closed", "clients": 2}
    mix["warmup"] = []
    with open(f"{registry.HERE}/configs/aerolab-wind-tunnel.py") as f:
        reference = f.read()
    bench, base = _cell_from_files(
        tmp_path, monkeypatch, mix,
        registry.load_json("configs", "aerolab-wind-tunnel"), reference)
    result, checks = run.run("dummy.cell", 2 ** 31 + 77, 2.0, False,
                             torch.device("cpu"), bench=bench, base=base)
    assert result["correct"] and result["failed"] == 0, result
    assert set(result["metrics"]) == {"setup_s", "tunnel_mlups",
                                      "requests_per_s"}
    assert result["attempted"] >= 4
    assert checks["step_or_alpha_wrong"]["value"] == 0


OPEN_REFERENCE = '''
def numbers(clients, cfg, device):
    """Every window request opened a session on the served grid."""
    (client,) = clients
    bad = sum(r.reply is None or r.reply["grid"] != cfg["grid"]
              or not r.reply["session"] for r in client.window)
    return {"sessions_wrong": bad}
'''


def test_portbench_open_loop_cell_runs_from_files_alone(tmp_path,
                                                        monkeypatch):
    """Open-loop arrivals over two connections, a file drawn anew for each
    request: data, a configuration and its reference. Each request counts
    from its arrival."""
    from portbench import run

    mix = {"arrival": {"kind": "open", "rate_per_s": 6.0,
                       "bursts": [1, 2], "block": 4, "connections": 2},
           "files": {"body": {"maker": "naca4", "camber_pct": [0, 4],
                              "camber_pos": [3, 5], "thickness_pct": [9, 15],
                              "points_per_side": 40, "per": "request"}},
           "values": {"alpha": {"each": [-4.0, 2.0, 8.0, 14.0]}},
           "block": 4,
           "window": [{"route": "/lbm/start", "files": {"file": "body"},
                       "fields": {"alpha": "{alpha}"}}]}
    config = {"grid": [192, 384], "limits": {"sessions_wrong": 0}}
    cell_spec = {"sample": {}, "spans": {}, "counters": {},
                 "trace": {"start_s": 0.5, "seconds": 0.5, "pad_s": 0.1}}
    bench, base = _cell_from_files(tmp_path, monkeypatch, mix, config,
                                   OPEN_REFERENCE, cell_spec)
    bench["end_to_end"] = [{"name": "setup_s", "unit": "s"},
                           {"name": "requests_per_s", "unit": "1/s"}]
    result, checks = run.run("dummy.cell", 5, 1.5, False,
                             torch.device("cpu"), bench=bench, base=base)
    assert result["correct"] and result["failed"] == 0, result
    # 6 a second for 1.5 s, in bursts of 1 and 2: 7 to 11 arrivals.
    assert 7 <= result["attempted"] <= 11
    assert checks == {"sessions_wrong": {"value": 0, "limit": 0}}
