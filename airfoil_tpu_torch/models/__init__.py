"""Analytic airfoil shapes (copies of the JAX package's NumPy generators)."""

from airfoil_tpu_torch.models.naca import naca4, clark_y, SHAPES
from airfoil_tpu_torch.models.joukowski import joukowski, joukowski_exact

__all__ = ["naca4", "clark_y", "SHAPES", "joukowski", "joukowski_exact"]
