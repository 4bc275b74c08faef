from airfoil_tpu_torch.utils.stats import (
    get_analysis_count,
    increment_analysis_count,
    init_db,
)
from airfoil_tpu_torch.utils.profiling import stage_timer, Timings

__all__ = [
    "get_analysis_count",
    "increment_analysis_count",
    "init_db",
    "stage_timer",
    "Timings",
]
