from airfoil_tpu_torch.polar.analyze import (
    INVISCID_WARNING,
    AnalysisResult,
    analyze_airfoil,
)
from airfoil_tpu_torch.polar.batch import BatchResult, solve_batch
from airfoil_tpu_torch.polar.sweep import (
    MODE_INVISCID,
    MODE_VISCOUS,
    MODE_VISCOUS_SMOOTHED,
    PolarResult,
    solve_polar,
    warm_polar_kernels,
)

__all__ = ["AnalysisResult", "BatchResult", "INVISCID_WARNING",
           "MODE_INVISCID", "MODE_VISCOUS", "MODE_VISCOUS_SMOOTHED",
           "PolarResult", "analyze_airfoil", "solve_batch", "solve_polar",
           "warm_polar_kernels"]
