"""XFOIL text-format interoperability (see ``xfoil``)."""

from airfoil_tpu_torch.interop.xfoil import (
    extract_aerodynamic_coefficients,
    parse_bl_dump,
    parse_cp_file,
    run_xfoil_if_available,
    write_xfoil_script,
)

__all__ = [
    "extract_aerodynamic_coefficients",
    "parse_bl_dump",
    "parse_cp_file",
    "run_xfoil_if_available",
    "write_xfoil_script",
]
