from airfoil_tpu_torch.paneling.panel import (
    Paneling,
    repanel,
    panel_geometry,
    rotate_about_quarter_chord,
)
from airfoil_tpu_torch.paneling.smooth import smooth_geometry

__all__ = [
    "Paneling",
    "repanel",
    "panel_geometry",
    "rotate_about_quarter_chord",
    "smooth_geometry",
]
