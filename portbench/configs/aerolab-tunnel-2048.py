"""Plain reference of the ``aerolab-tunnel-2048`` configuration.

The viewer's reference tunnel (``configs/aerolab-wind-tunnel.py``: its
``Tunnel``, ``scanline`` inside it, ``parse_selig``, ``decode``,
``encode`` and ``session_start``, loaded through ``portbench.registry``
and not copied) on this configuration's lattice. It steps the lattice's
``steps_per_frame`` a frame and compares the fields each request named.
It runs in any floating dtype: float64 is the reference, and bfloat16 is
the control that a correct comparison has to reject.

It stops early where the session served is not this configuration's, so
that a program serving a smaller lattice cannot keep it replaying for
minutes: a set-up whose ``/lbm/start`` reply gives another ``grid``
counts every window frame in ``step_or_alpha_wrong`` and every cell of
each field a kept frame named in ``body_cells_wrong``, without stepping;
at the first frame whose ``step`` differs from the reference's, that
frame and the rest of the window count in ``step_or_alpha_wrong``.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from portbench import registry

_viewer = registry.load_module("configs", "aerolab-wind-tunnel")
Tunnel = _viewer.Tunnel
parse_selig = _viewer.parse_selig
decode = _viewer.decode
encode = _viewer.encode
session_start = _viewer.session_start
FIELDS = _viewer.FIELDS           # name -> scale (None: of u0)
ROUNDING = _viewer.ROUNDING


def _start(setup: list):
    return next(r for r in setup if r.route == "/lbm/start")


def served_grid(setup: list):
    """The ``grid`` of the set-up's ``/lbm/start`` reply, None where the
    set-up holds no reply (the control's)."""
    reply = getattr(_start(setup), "reply", None)
    return None if reply is None else list(reply["grid"])


def named(rec) -> list:
    """The fields a frame's request named."""
    return [n for n in rec.fields.get("fields", "speed").split(",") if n]


def _count_wrong(frames: list, lat: dict, worst: dict, cells: bool):
    for rec in frames:
        worst["step_or_alpha_wrong"] += 1
        if cells and rec.reply is not None and "fields" in rec.reply:
            worst["body_cells_wrong"] += \
                lat["nx"] * lat["ny"] * len(named(rec))


def numbers(clients: list, cfg: dict, device,
            dtype=torch.float64) -> dict:
    """Follow each client's served session in the reference and compare
    every frame with it (a client holds ``setup`` and ``window``, each
    request with its form as sent and its parsed reply, as the viewer's
    reference takes them). Returns the worst reading of each number
    compared."""
    worst = {"step_or_alpha_wrong": 0, "body_cells_wrong": 0,
             "field_err": 0.0, "force_err": 0.0, "separation_err": 0.0,
             "outline_err": 0.0}
    for client in clients:
        _follow(client, cfg, device, dtype, worst)
    return worst


def _follow(client, cfg: dict, device, dtype, worst: dict):
    lat = cfg["lattice"]
    frames = [r for r in client.window if r.route == "/lbm/frame"]
    grid = served_grid(client.setup)
    if grid is not None and grid != [lat["ny"], lat["nx"]]:
        _count_wrong(frames, lat, worst, cells=True)
        return
    text, alpha0 = session_start(client.setup)
    steps = lat["steps_per_frame"]
    tunnel = Tunnel(parse_selig(text), lat, alpha0, device, dtype,
                    cfg["separation_band_u0"])
    for k, rec in enumerate(frames):
        alpha, reply = float(rec.fields["alpha"]), rec.reply
        if abs(alpha - tunnel.alpha) > 1e-6:
            tunnel.set_alpha(alpha)
        want = reply is not None and "fields" in reply
        ref = tunnel.frame(steps, want)
        if reply is None:       # a failed request, counted by the harness
            continue
        if reply["step"] != ref["step"]:
            _count_wrong(frames[k:], lat, worst, cells=False)
            return
        if reply["alpha"] != alpha:
            worst["step_or_alpha_wrong"] += 1
        worst["force_err"] = max(worst["force_err"],
                                 abs(reply["cl"] - ref["cl"]),
                                 abs(reply["cd"] - ref["cd"]))
        lo, hi = ref["separation_band"]
        worst["separation_err"] = max(
            worst["separation_err"], lo - ROUNDING - reply["separation"],
            reply["separation"] - hi - ROUNDING)
        outline = np.asarray(reply["outline"], np.float64)
        worst["outline_err"] = max(worst["outline_err"], float(
            np.abs(outline - tunnel.outline).max())
            if outline.shape == tunnel.outline.shape else math.inf)
        if not want:
            continue
        for name in named(rec):
            exp = ref["fields"][name]
            field = reply["fields"].get(name)
            got = decode(field) if field is not None else None
            if got is None or got.shape != exp.shape:
                worst["body_cells_wrong"] += exp.size
                continue
            worst["body_cells_wrong"] += int(
                (np.isnan(got) != np.isnan(exp)).sum())
            both = ~(np.isnan(got) | np.isnan(exp))
            err = np.abs(got[both] - exp[both]).max() / (FIELDS[name]
                                                         or lat["u0"])
            worst["field_err"] = max(worst["field_err"], float(err))


def served(setup: list, requests: list, keep: set, cfg: dict, device,
           dtype) -> list:
    """The frames that the reference in ``dtype`` serves for a client's
    window ``requests`` after its ``setup``, rounded and encoded as the
    service does, with the named fields of the frames in ``keep``: the
    control puts these in the program's place."""
    lat = cfg["lattice"]
    text, alpha0 = session_start(setup)
    steps = lat["steps_per_frame"]
    tunnel = Tunnel(parse_selig(text), lat, alpha0, device, dtype)
    frames = []
    for k, req in enumerate(requests):
        alpha = float(req.fields["alpha"])
        if abs(alpha - tunnel.alpha) > 1e-6:
            tunnel.set_alpha(alpha)
        out = tunnel.frame(steps, k in keep)
        reply = {"cl": round(out["cl"], 4), "cd": round(out["cd"], 4),
                 "separation": round(out["separation"], 4),
                 "step": out["step"], "alpha": alpha,
                 "outline": tunnel.outline.round(5).tolist()}
        if k in keep:
            reply["fields"] = {n: encode(out["fields"][n])
                               for n in named(req)}
        frames.append(SimpleNamespace(route=req.route, fields=req.fields,
                                     reply=reply))
    return frames
