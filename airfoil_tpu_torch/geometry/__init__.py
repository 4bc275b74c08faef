"""Airfoil ``.dat`` parsing and multi-element detection: a copy of
``airfoil_tpu/geometry`` (pure Python), kept so that the port imports
nothing of the JAX package."""

from airfoil_tpu_torch.geometry.parser import (
    AirfoilParseError,
    parse_dat_file,
    parse_dat_text,
    detect_and_merge_sections,
)
from airfoil_tpu_torch.geometry.multielement import (
    count_le_passes,
    is_multi_element,
)

__all__ = [
    "AirfoilParseError",
    "parse_dat_file",
    "parse_dat_text",
    "detect_and_merge_sections",
    "count_le_passes",
    "is_multi_element",
]
