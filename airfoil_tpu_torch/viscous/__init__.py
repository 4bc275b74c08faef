# ``march_side`` is the kernel wrapper: the CUDA march on a CUDA tensor, the
# plain torch march (``viscous.march.march_side``) on a CPU tensor.
from airfoil_tpu_torch.viscous.kernel import march_side
from airfoil_tpu_torch.viscous.march import BLState, stagnation_ic
from airfoil_tpu_torch.viscous.coupled import ViscousResult, solve_viscous
from airfoil_tpu_torch.viscous.newton import (
    solve_polar_point,
    solve_polar_point_cont,
    solve_viscous_newton,
)

__all__ = [
    "BLState",
    "march_side",
    "stagnation_ic",
    "ViscousResult",
    "solve_viscous",
    "solve_viscous_newton",
    "solve_polar_point",
    "solve_polar_point_cont",
]
