"""Off-body flow-field computation for visualisation: port of
``airfoil_tpu/inviscid/flowfield.py``.

The linear-vortex solution evaluated on a grid (one batched influence
evaluation on the device, ``velocity_at_points``), the body's interior
masked by an even-odd point-in-polygon test of the port's own (the
reference uses ``matplotlib.path.Path.contains_points`` with a radius of
-1e-4; the two agree except within ~1e-4 of the loop), and the reference's
streamline tracer with its parameters (22 seed lines, 800 steps, dt 0.004;
bilinear velocity, an explicit step, a line stops on leaving the grid, at
a NaN or a stagnant velocity, or when its next point falls inside the
body), advancing every line together in float64 with each line's
arithmetic as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airfoil_tpu_torch.device import resolve_device
from airfoil_tpu_torch.inviscid.panel_solver import (
    build_operator,
    velocity_at_points,
)
from airfoil_tpu_torch.inviscid.programs import inviscid_program
from airfoil_tpu_torch.paneling import panel_geometry, repanel

__all__ = ["FlowField", "compute_flow_field", "points_in_loop"]

_N_STEPS = 800
_DT = 0.004


class FlowField(NamedTuple):
    x: np.ndarray            # (G,) grid x
    y: np.ndarray            # (G,) grid y
    speed: np.ndarray        # (G, G) |V|, 0 inside body
    u: np.ndarray            # NaN inside body
    v: np.ndarray
    streamlines: list        # list of (xs, ys) polylines
    coords: np.ndarray       # the input loop
    cl: float
    cp_min: float


def points_in_loop(loop: np.ndarray, px: np.ndarray,
                   py: np.ndarray) -> np.ndarray:
    """Even-odd test of the points (px, py) against the closed polygon
    through ``loop``'s vertices (the last joined to the first)."""
    x0, y0 = loop[:, 0], loop[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(np.shape(px), bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(len(x0)):
            crosses = (y0[i] > py) != (y1[i] > py)
            x_cut = x0[i] + (py - y0[i]) * (x1[i] - x0[i]) / (y1[i] - y0[i])
            inside ^= crosses & (px < x_cut)
    return inside


def _trace(x_arr, y_arr, u, v, loop, n_streamlines: int) -> list:
    """The reference's tracer for every seed line at once."""
    g = len(x_arr)
    seeds = np.linspace(y_arr[0] + 0.03, y_arr[-1] - 0.03, n_streamlines)
    xs = [[x_arr[0] + 0.02] for _ in seeds]
    ys = [[y] for y in seeds]
    cx = np.full(len(seeds), x_arr[0] + 0.02)
    cy = seeds.copy()
    live = np.ones(len(seeds), bool)
    for _ in range(_N_STEPS):
        live &= ((x_arr[0] <= cx) & (cx <= x_arr[-1])
                 & (y_arr[0] <= cy) & (cy <= y_arr[-1]))
        if not live.any():
            break
        ix = np.clip(np.searchsorted(x_arr, cx) - 1, 0, g - 2)
        iy = np.clip(np.searchsorted(y_arr, cy) - 1, 0, g - 2)
        fx = (cx - x_arr[ix]) / (x_arr[ix + 1] - x_arr[ix] + 1e-12)
        fy = (cy - y_arr[iy]) / (y_arr[iy + 1] - y_arr[iy] + 1e-12)
        uu = (u[iy, ix] * (1 - fx) * (1 - fy) + u[iy, ix + 1] * fx * (1 - fy)
              + u[iy + 1, ix] * (1 - fx) * fy + u[iy + 1, ix + 1] * fx * fy)
        vv = (v[iy, ix] * (1 - fx) * (1 - fy) + v[iy, ix + 1] * fx * (1 - fy)
              + v[iy + 1, ix] * (1 - fx) * fy + v[iy + 1, ix + 1] * fx * fy)
        live &= ~(np.isnan(uu) | np.isnan(vv) | (np.hypot(uu, vv) < 1e-6))
        nx_pt, ny_pt = cx + _DT * uu, cy + _DT * vv
        live &= ~points_in_loop(loop, nx_pt, ny_pt)
        for i in np.flatnonzero(live):
            xs[i].append(float(nx_pt[i]))
            ys[i].append(float(ny_pt[i]))
        cx = np.where(live, nx_pt, cx)
        cy = np.where(live, ny_pt, cy)
    return [(px, py) for px, py in zip(xs, ys) if len(px) > 5]


def compute_flow_field(
    coords,
    alpha_deg: float,
    n_streamlines: int = 22,
    grid_res: int = 220,
    n_panels: int = 160,
    device=None,
) -> FlowField:
    """Velocity field + streamlines around the airfoil at one alpha, the
    panel solve and the field on ``device`` (see ``resolve_device``)."""
    dev = resolve_device(device)
    coords = np.asarray(coords, np.float64)
    # Repanelled as a lane of one: a lane's arc length is accumulated in
    # float64 (``paneling.panel._arc_length``), so the card's nodes equal
    # the CPU's, and the field near the surface, which turns on them, too.
    xp, yp = repanel(coords[None].astype(np.float32), n_panels, device=dev)
    op = build_operator(panel_geometry(xp[0], yp[0]))
    sol = inviscid_program(op, float(alpha_deg))

    chord = coords[:, 0].max() - coords[:, 0].min()
    pad = 0.60 * chord
    x_arr = np.linspace(coords[:, 0].min() - pad, coords[:, 0].max() + pad,
                        grid_res)
    y_arr = np.linspace(coords[:, 1].min() - pad, coords[:, 1].max() + pad,
                        grid_res)
    xg, yg = np.meshgrid(x_arr, y_arr)

    def on_dev(a):
        return torch.as_tensor(a.ravel().astype(np.float32), device=dev)

    u, v = velocity_at_points(on_dev(xg), on_dev(yg), op, sol.gamma,
                              float(alpha_deg))
    u = u.cpu().numpy().astype(np.float64).reshape(grid_res, grid_res)
    v = v.cpu().numpy().astype(np.float64).reshape(grid_res, grid_res)

    inside = points_in_loop(coords, xg, yg)

    speed = np.hypot(u, v)
    outside_vals = speed[~inside]
    # Same percentile clip as the reference (99.99th, Airfoil_Analysis.py:202)
    p999 = float(np.percentile(outside_vals, 99.99))
    speed = np.clip(speed, 0.0, p999)
    speed[inside] = 0.0
    u[inside] = np.nan
    v[inside] = np.nan

    streamlines = _trace(x_arr, y_arr, u, v, coords, n_streamlines)
    return FlowField(x=x_arr, y=y_arr, speed=speed, u=u, v=v,
                     streamlines=streamlines, coords=coords,
                     cl=float(sol.cl), cp_min=float(sol.cp.min()))
