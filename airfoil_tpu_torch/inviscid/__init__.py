from airfoil_tpu_torch.inviscid.panel_solver import (
    InviscidOperator,
    InviscidSolution,
    build_operator,
    operator_from_numpy,
    solve_inviscid,
    velocity_at_points,
)

__all__ = [
    "InviscidOperator",
    "InviscidSolution",
    "build_operator",
    "operator_from_numpy",
    "solve_inviscid",
    "velocity_at_points",
]
