"""XFOIL text-format interoperability: a copy of
``airfoil_tpu/interop/xfoil.py``, kept so that the port imports nothing of
the JAX package.

The reference service is glued to the XFOIL binary through three text
formats: the stdout coefficient block, the ``CPWR`` pressure file and the
``DUMP`` boundary-layer file. This module parses them with the reference's
semantics and output dicts, writes the command script, and drives a real
XFOIL executable (``XFOIL_PATH`` or ``xfoil`` on ``PATH``) where one is
installed, which gives the parity harness (``airfoil_tpu_torch/bench``) a
live ground truth.
"""

from __future__ import annotations

import os
import re

__all__ = [
    "extract_aerodynamic_coefficients",
    "parse_bl_dump",
    "parse_cp_file",
    "write_xfoil_script",
    "run_xfoil_if_available",
]

_COEFF_PATTERNS = {
    "CL": r"CL\s*=\s*([-+]?\d*\.?\d+)",
    "CD": r"CD\s*=\s*([-+]?\d*\.?\d+)",
    "CDp": r"CDp\s*=\s*([-+]?\d*\.?\d+)",
    "Cm": r"Cm\s*=\s*([-+]?\d*\.?\d+)",
}


def extract_aerodynamic_coefficients(stdout: str) -> dict:
    """Scrape CL/CD/CDp/Cm from XFOIL stdout.

    Takes the LAST occurrence of each — the final converged value after
    the Newton iteration trace (reference main.py:183-196 semantics).
    Returns an empty dict when nothing matches.
    """
    coefficients = {}
    for key, pattern in _COEFF_PATTERNS.items():
        matches = re.findall(pattern, stdout)
        if matches:
            coefficients[key] = float(matches[-1])
    return coefficients


def parse_cp_file(path: str) -> tuple[list[float], list[float]]:
    """Parse an XFOIL ``CPWR`` output file into (x, cp) lists.

    Skips headers (any line containing letters) and malformed rows
    (reference main.py:470-485 semantics).
    """
    cp_x: list[float] = []
    cp_values: list[float] = []
    with open(path, "r") as f:
        for line in f:
            clean = line.strip()
            if not clean or any(c.isalpha() for c in clean):
                continue
            parts = clean.split()
            if len(parts) >= 2:
                try:
                    x = float(parts[0])
                    cp = float(parts[1])
                except ValueError:
                    continue
                cp_x.append(x)
                cp_values.append(cp)
    return cp_x, cp_values


def _find_transition_x(rows: list[dict]) -> float | None:
    """Detect transition as a |Cf| jump by a factor > 2.5 between adjacent
    stations (reference main.py:257-270)."""
    if len(rows) < 4:
        return None
    for i in range(1, len(rows) - 1):
        prev_cf = abs(rows[i - 1]["cf"])
        curr_cf = abs(rows[i]["cf"])
        if prev_cf > 1e-6 and curr_cf > 1e-6 and curr_cf / prev_cf > 2.5:
            return rows[i]["x"]
    return None


def parse_bl_dump(bl_file_path: str) -> dict | None:
    """Parse an XFOIL ``DUMP`` boundary-layer file.

    Column order (8 columns): s x y Ue/Vinf Dstar Theta Cf H. Section 1
    (before the first blank line) is the upper surface TE->LE; section 2
    the lower surface LE->TE (reference main.py:199-281). Returns the
    reference's dict shape or ``None`` when the file is missing/empty.
    """
    if not os.path.exists(bl_file_path):
        return None

    sections: list[list[dict]] = []
    current: list[dict] = []
    try:
        with open(bl_file_path, "r") as f:
            for line in f:
                stripped = line.strip()
                if not stripped:
                    if current:
                        sections.append(current)
                        current = []
                    continue
                parts = stripped.split()
                if len(parts) < 7:
                    continue
                try:
                    vals = [float(p) for p in parts[:7]]
                except ValueError:
                    continue
                h = float(parts[7]) if len(parts) >= 8 else None
                current.append({
                    "x": vals[1], "y": vals[2], "dstar": vals[4],
                    "theta": vals[5], "cf": vals[6], "H": h,
                })
        if current:
            sections.append(current)
        if not sections:
            return None
        upper = sections[0] if len(sections) > 0 else []
        lower = sections[1] if len(sections) > 1 else []
        return {
            "upper": upper,
            "lower": lower,
            "transition_upper_x": _find_transition_x(upper),
            "transition_lower_x": _find_transition_x(lower),
        }
    except Exception:
        return None


def write_xfoil_script(
    coords_filename: str,
    cp_filename: str,
    bl_filename: str,
    reynolds: float,
    alpha: float,
    viscous: bool = True,
    smooth_geometry: bool = False,
    iter_limit: int = 500,
) -> str:
    """Build the XFOIL command script the reference writes
    (main.py:351-373): LOAD/PANE/[GDES SMOO]/OPER/VISC/ITER/ALFA/CPWR/DUMP.
    """
    lines = [f"LOAD {coords_filename}", "PANE"]
    if smooth_geometry:
        lines += ["GDES", "SMOO", ""]
    lines.append("OPER")
    if viscous:
        lines += [f"VISC {int(reynolds)}", f"ITER {iter_limit}"]
    lines.append(f"ALFA {alpha}")
    lines.append(f"CPWR {cp_filename}")
    if viscous:
        lines.append(f"DUMP {bl_filename}")
    lines += ["", "QUIT"]
    return "\n".join(lines)


def run_xfoil_if_available(
    coords_path: str,
    reynolds: float,
    alpha: float,
    work_dir: str,
    timeout: int = 90,
    viscous: bool = True,
    smooth_geometry: bool = False,
):
    """Run a real XFOIL binary for ground-truth parity when one exists.

    Returns ``(coefficients, cp_x, cp_values, bl_data)`` or ``None`` when
    no binary is on PATH / at ``XFOIL_PATH``. Mirrors the reference's
    ``_run_xfoil_mode`` (main.py:328-519) minus the logging theatre.
    """
    import shutil
    import subprocess

    exe = os.getenv("XFOIL_PATH", "xfoil")
    if shutil.which(exe) is None and not os.path.exists(exe):
        return None

    cp_name, bl_name = "cp_output.txt", "bl_output.txt"
    script = write_xfoil_script(
        os.path.basename(coords_path), cp_name, bl_name,
        reynolds, alpha, viscous, smooth_geometry)
    os.makedirs(work_dir, exist_ok=True)
    local_coords = os.path.join(work_dir, os.path.basename(coords_path))
    if os.path.abspath(local_coords) != os.path.abspath(coords_path):
        shutil.copy(coords_path, local_coords)
    script_path = os.path.join(work_dir, "xfoil_script.txt")
    with open(script_path, "w", newline="\n") as f:
        f.write(script)
    with open(script_path, "r") as script_file:
        proc = subprocess.Popen(
            [exe], stdin=script_file, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=work_dir)
    try:
        stdout, _stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        return None

    if ("VISCAL:  Convergence failed" in stdout
            or "not converged" in stdout.lower()
            or "unconverged" in stdout.lower()):
        return None
    coeffs = extract_aerodynamic_coefficients(stdout)
    if "CL" not in coeffs:
        return None
    cp_path = os.path.join(work_dir, cp_name)
    if not os.path.exists(cp_path):
        return None
    cp_x, cp_values = parse_cp_file(cp_path)
    bl = parse_bl_dump(os.path.join(work_dir, bl_name)) if viscous else None
    return coeffs, cp_x, cp_values, bl
