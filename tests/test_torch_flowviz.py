"""The port's flow-field renderers (``airfoil_tpu_torch.ui.flowviz``)
against the JAX package's, on the port's own field.

The field is the port's ``compute_flow_field`` on the CPU for NACA 2412
(60 points a side) at alpha 5 on a 90 x 90 grid at 100 panels, as
``tests/test_flowviz.py`` makes its own. Both packages' ``render_heatmap_png``
of that field must decode to equal pixels; the plotly builders need plotly,
an optional frontend package, and skip without it as the reference's test
does.
"""

import base64
import io

import numpy as np
import pytest

from airfoil_tpu.ui import flowviz as ref_flowviz
from airfoil_tpu_torch.inviscid.flowfield import compute_flow_field
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.ui import flowviz

BL = {
    "upper": [{"x": 0.1 * i, "y": 0.05, "dstar": 0.002 * i, "theta": 0.001,
               "cf": 0.002, "H": 1.5} for i in range(1, 10)],
    "lower": [{"x": 0.1 * i, "y": -0.04, "dstar": 0.001 * i, "theta": 0.001,
               "cf": 0.002, "H": 1.5} for i in range(1, 10)],
    "transition_upper_x": 0.4,
    "transition_lower_x": 0.7,
}


@pytest.fixture(scope="module")
def field():
    return compute_flow_field(np.asarray(naca4(2, 4, 12, 60)), 5.0,
                              grid_res=90, n_panels=100, device="cpu")


def _pixels(b64: str) -> np.ndarray:
    import matplotlib.image as mpimg
    png = base64.b64decode(b64)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return mpimg.imread(io.BytesIO(png), format="png")


@pytest.mark.parametrize("dpi", [60, 110])
def test_heatmap_pixels_equal(field, dpi):
    got = _pixels(flowviz.render_heatmap_png(field, dpi=dpi))
    want = _pixels(ref_flowviz.render_heatmap_png(field, dpi=dpi))
    assert got.shape == want.shape and got.shape[2] in (3, 4)
    np.testing.assert_array_equal(got, want)
    # The fixed 0..2 scale paints the field: more than the frame is drawn.
    assert len(np.unique(got.reshape(-1, got.shape[2]), axis=0)) > 50


def test_field_as_reference_test(field):
    """``tests/test_flowviz.py``'s checks of its field, on the port's."""
    assert field.speed.shape == (90, 90)
    assert len(field.streamlines) >= 10
    assert abs(float(field.speed[0, 0]) - 1.0) < 0.2
    assert float(field.cl) == pytest.approx(0.856, abs=0.05)


def test_plotly_builders(field):
    pytest.importorskip("plotly")
    fig = flowviz.build_flow_animation(field, n_frames=10)
    ref = ref_flowviz.build_flow_animation(field, n_frames=10)
    assert len(fig.frames) == len(ref.frames) == 10
    assert fig.to_json() == ref.to_json()
    coords = np.asarray(naca4(2, 4, 12, 60))
    traces = flowviz.build_bl_overlay(coords, BL)
    assert len(traces) == 4
    assert [t.to_plotly_json() for t in traces] == \
        [t.to_plotly_json() for t in ref_flowviz.build_bl_overlay(coords, BL)]
