from airfoil_tpu_torch.polar.analyze import (
    INVISCID_WARNING,
    AnalysisResult,
    analyze_airfoil,
)

__all__ = ["AnalysisResult", "INVISCID_WARNING", "analyze_airfoil"]
