from airfoil_tpu_torch.utils.stats import (
    get_analysis_count,
    increment_analysis_count,
    init_db,
)

__all__ = ["get_analysis_count", "increment_analysis_count", "init_db"]
