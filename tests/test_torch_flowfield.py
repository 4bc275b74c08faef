"""The port's flow field (``inviscid/flowfield.py``) against the JAX
package's on the CPU.

- The point-in-polygon mask: the port's even-odd test equals
  ``matplotlib.path.Path.contains_points(radius=-1e-4)`` (the reference's)
  on a 220 x 220 grid around NACA 2412 and around a parsed corpus loop,
  except at points within 2e-4 of the loop, which are counted (a
  handful).
- ``compute_flow_field`` of NACA 2412 at alpha 5 on a 60 x 60 grid with
  80 panels: the same grid; u and v within rtol 1e-4 (atol 1e-6: the
  float32 panel sums of two implementations) where both are outside the
  body; the same masked points except within 2e-4 of the loop; CL within
  1e-5 and cp_min within 1e-4; speed the same where neither mask nor
  percentile clip differs; the same number of streamlines, each starting
  on the same seed and its first 50 points within 1e-4.
"""

import numpy as np
import pytest
from matplotlib.path import Path

from airfoil_tpu.inviscid.flowfield import compute_flow_field as ref_flow
from airfoil_tpu_torch.bench.corpus import generate_corpus
from airfoil_tpu_torch.geometry import parse_dat_file
from airfoil_tpu_torch.inviscid.flowfield import (compute_flow_field,
                                                  points_in_loop)
from airfoil_tpu_torch.models import naca4

NEAR = 2e-4
GRID = 60


def _distance_to_loop(loop, px, py):
    """Each point's distance to the closed polygon through ``loop``."""
    a = loop
    b = np.roll(loop, -1, axis=0)
    best = np.full(px.shape, np.inf)
    for (ax, ay), (bx, by) in zip(a, b):
        dx, dy = bx - ax, by - ay
        t = np.clip(((px - ax) * dx + (py - ay) * dy)
                    / max(dx * dx + dy * dy, 1e-30), 0.0, 1.0)
        best = np.minimum(best, np.hypot(px - ax - t * dx, py - ay - t * dy))
    return best


def _grid(loop, res):
    pad = 0.6 * (loop[:, 0].max() - loop[:, 0].min())
    x = np.linspace(loop[:, 0].min() - pad, loop[:, 0].max() + pad, res)
    y = np.linspace(loop[:, 1].min() - pad, loop[:, 1].max() + pad, res)
    return np.meshgrid(x, y)


def _loops(tmp_path):
    files = generate_corpus(str(tmp_path), n=4, seed=0)
    lednicer = [p for p in files if p.endswith("_lednicer.dat")][0]
    return {"naca2412": np.asarray(naca4(2, 4, 12, 100), np.float64),
            "lednicer": np.asarray(parse_dat_file(lednicer)[0], np.float64)}


@pytest.mark.parametrize("name", ["naca2412", "lednicer"])
def test_mask_equals_matplotlib_off_the_loop(name, tmp_path):
    loop = _loops(tmp_path)[name]
    xg, yg = _grid(loop, 220)
    got = points_in_loop(loop, xg, yg)
    want = Path(loop).contains_points(np.c_[xg.ravel(), yg.ravel()],
                                      radius=-1e-4).reshape(xg.shape)
    differ = got != want
    near = _distance_to_loop(loop, xg, yg) <= NEAR
    print(f"{name}: {int(differ.sum())} of {differ.size} points differ, "
          f"all within {NEAR} of the loop ({int(near.sum())} such points)")
    assert not (differ & ~near).any()
    assert differ.sum() <= 20
    assert 200 < got.sum() < 0.2 * got.size


def test_flow_field_against_reference():
    coords = naca4(2, 4, 12, 100)
    got = compute_flow_field(coords, 5.0, grid_res=GRID, n_panels=80,
                             device="cpu")
    want = ref_flow(coords, 5.0, grid_res=GRID, n_panels=80)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    xg, yg = np.meshgrid(got.x, got.y)
    near = _distance_to_loop(np.asarray(coords, np.float64), xg, yg) <= NEAR
    in_got, in_want = np.isnan(got.u), np.isnan(want.u)
    assert not ((in_got != in_want) & ~near).any()
    both = ~in_got & ~in_want
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f)[both],
                                   getattr(want, f)[both], rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert abs(got.cl - want.cl) <= 1e-5
    assert abs(got.cp_min - want.cp_min) <= 1e-4
    clip = min(got.speed.max(), want.speed.max())
    same = both & (got.speed < clip) & (want.speed < clip)
    np.testing.assert_allclose(got.speed[same], want.speed[same], rtol=1e-4,
                               atol=1e-6)
    assert len(got.streamlines) == len(want.streamlines) > 10
    for (gx, gy), (wx, wy) in zip(got.streamlines, want.streamlines):
        assert (gx[0], gy[0]) == (wx[0], wy[0])
        n = min(50, len(gx), len(wx))
        np.testing.assert_allclose(np.c_[gx[:n], gy[:n]],
                                   np.c_[wx[:n], wy[:n]], atol=1e-4)
