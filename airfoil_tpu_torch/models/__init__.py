"""Analytic airfoil shapes (a copy of the JAX package's ``naca4``)."""

from airfoil_tpu_torch.models.naca import naca4

__all__ = ["naca4"]
