"""Airfoil ``.dat`` coordinate parser and geometry repairer.

This is the robustness layer that lifted the reference's XFOIL convergence on
the 1,000-airfoil UIUC database from 22.5% to 85.7% (reference
benchmark/benchmark_summary.json). The repair semantics reproduced here, each
validated by the ported unit tests in ``tests/test_parser.py``:

- header / comment / garbage line skipping (reference main.py:74-91)
- out-of-range point filtering, x in [-0.5, 1.5], y in [-1, 1] (main.py:85)
- minimum 10 valid points (main.py:98-100)
- Lednicer two-section detection (x drops below 0.01 after exceeding 0.5,
  main.py:124-127) and merge into a single Selig TE->upper->LE->lower->TE
  loop (main.py:139-150)
- duplicate leading-edge removal when merging Lednicer sections (main.py:146-149)
- reversed-Selig winding correction using the sign of y just before the LE
  (main.py:153-167)
- deliberate preservation of a coincident first/last trailing-edge point:
  NACA 6-series files are a closed loop and opening the TE breaks
  convergence (main.py:173-179)

The human-readable "fixes" strings are part of the JSON contract consumed by
the frontend console box (reference pages/Airfoil_Analysis.py:1291-1341), so
their wording matches the reference exactly.

The parser is deliberately pure Python: it runs host-side once per request.

A copy of ``airfoil_tpu/geometry/parser.py``: the port keeps its own copies
and imports nothing of the JAX package. ``tests/test_torch_isolation.py``
holds the two equal on the repo's ``.dat`` fixtures.
"""

from __future__ import annotations

import os
from typing import Iterable

__all__ = [
    "AirfoilParseError",
    "parse_dat_file",
    "parse_dat_text",
    "detect_and_merge_sections",
]

# Valid coordinate window (reference main.py:85).
X_RANGE = (-0.5, 1.5)
Y_RANGE = (-1.0, 1.0)
MIN_VALID_POINTS = 10


class AirfoilParseError(ValueError):
    """Raised when a .dat file cannot be parsed into a usable airfoil.

    Carries an HTTP-ish ``status_code`` so the API layer can map it straight
    onto the reference's HTTPException(400) behaviour (main.py:99,113).
    """

    def __init__(self, detail: str, status_code: int = 400,
                 code: str = "parse_error"):
        super().__init__(detail)
        self.detail = detail
        self.status_code = status_code
        # Machine-readable reason (e.g. "too_few_points") so tooling like
        # the parser benchmark classifies on a stable field instead of
        # substring-matching user-facing text.
        self.code = code


def parse_dat_text(text: str) -> tuple[list[list[float]], list[str]]:
    """Parse airfoil coordinates from the text of a .dat file.

    Returns ``(coords, fixes)`` where ``coords`` is a list of ``[x, y]``
    floats in Selig order and ``fixes`` is a list of human-readable repair
    descriptions (empty repairs collapse to the no-op message, reference
    main.py:105-106).
    """
    fixes: list[str] = []
    data_lines: list[list[float]] = []
    skipped_non_coord = 0
    skipped_out_of_range = 0

    for raw in text.splitlines():
        stripped = raw.strip()
        if not stripped:
            continue
        parts = stripped.split()
        if len(parts) < 2:
            skipped_non_coord += 1
            continue
        try:
            x = float(parts[0])
            y = float(parts[1])
        except ValueError:
            skipped_non_coord += 1
            continue
        if X_RANGE[0] <= x <= X_RANGE[1] and Y_RANGE[0] <= y <= Y_RANGE[1]:
            data_lines.append([x, y])
        else:
            skipped_out_of_range += 1

    if skipped_non_coord > 0:
        fixes.append(
            f"Non-coordinate lines skipped: {skipped_non_coord} "
            f"header/comment line(s) removed"
        )
    if skipped_out_of_range > 0:
        fixes.append(
            f"Out-of-range points filtered: {skipped_out_of_range} "
            f"point(s) outside valid bounds removed"
        )

    if len(data_lines) < MIN_VALID_POINTS:
        raise AirfoilParseError(
            f"Insufficient valid coordinates. Found {len(data_lines)} points.",
            code="too_few_points",
        )

    coords, geom_fixes = detect_and_merge_sections(data_lines)
    fixes.extend(geom_fixes)

    if not fixes:
        fixes = ["No changes made — file was already in valid Selig format"]

    return coords, fixes


def parse_dat_file(file_path: str | os.PathLike) -> tuple[list[list[float]], list[str]]:
    """Parse airfoil coordinates from a .dat file on disk.

    Same contract as the reference's ``parse_dat_file`` (main.py:59-113):
    returns ``(coords, fixes)`` or raises :class:`AirfoilParseError`.
    """
    try:
        with open(file_path, "r", errors="ignore") as f:
            text = f.read()
    except AirfoilParseError:
        raise
    except Exception as e:  # missing file, permission, decode...
        raise AirfoilParseError(f"Failed to parse file: {e}") from e
    return parse_dat_text(text)


def _is_origin(pt: Iterable[float], tol: float = 1e-3) -> bool:
    x, y = pt[0], pt[1]
    return abs(x) < tol and abs(y) < tol


def detect_and_merge_sections(
    data_lines: list[list[float]],
) -> tuple[list[list[float]], list[str]]:
    """Detect Selig vs Lednicer layout and repair into a Selig loop.

    Reference semantics (main.py:116-180):

    * A *section break* is the first index ``i`` where ``x[i] < 0.01`` while
      ``x[i-1] > 0.5`` — the trace jumped from the trailing edge back to the
      leading edge, i.e. the file holds two LE->TE surface lists (Lednicer).
    * Lednicer repair: normalise the upper surface to TE->LE, the lower to
      LE->TE, drop a duplicated (0,0) LE shared by both sections, and
      concatenate into one Selig loop.
    * Single-section files that start and end near the TE (x > 0.99 at both
      ends) are checked for winding: the point immediately *before* the LE
      must be on the upper surface (y > 0). If not, the whole loop is
      reversed.
    * A coincident first/last TE point is preserved: NACA 6-series files are
      legitimately closed loops and opening the TE breaks the solve
      (main.py:173-179).
    """
    fixes: list[str] = []
    xs = [pt[0] for pt in data_lines]

    section_break = None
    for i in range(1, len(data_lines)):
        if xs[i] < 0.01 and xs[i - 1] > 0.5:
            section_break = i
            break

    if section_break is not None:
        upper = data_lines[:section_break]
        lower = data_lines[section_break:]
        fixes.append(
            f"Lednicer format detected and converted: two-section format "
            f"({len(upper)} upper + {len(lower)} lower points) merged into "
            f"a single Selig-format loop for XFOIL"
        )
        # Normalise upper to LE->TE, then flip to TE->LE for the Selig loop.
        if upper and upper[0][0] > upper[-1][0]:
            upper = upper[::-1]
        upper = upper[::-1]
        # Normalise lower to LE->TE.
        if lower and lower[0][0] > lower[-1][0]:
            lower = lower[::-1]
        # Both sections usually share the (0,0) LE point; keep only one.
        if lower and _is_origin(lower[0]):
            lower = lower[1:]
            fixes.append(
                "Duplicate leading-edge point removed from Lednicer lower section"
            )
        merged = upper + lower
        return merged, fixes

    # Single-section (Selig-style) file.
    merged = data_lines
    if xs[0] > 0.99 and xs[-1] > 0.99:
        le_idx = xs.index(min(xs))
        if le_idx > 0 and data_lines[le_idx - 1][1] <= 0:
            # TE->lower->LE->upper->TE: wrong winding, flip the loop.
            merged = data_lines[::-1]
            fixes.append(
                "Winding order corrected: coordinates were in reversed order "
                "(TE→lower→LE→upper→TE) and have been reversed to the correct "
                "Selig order (TE→upper→LE→lower→TE)"
            )

    # NOTE: a coincident first/last TE point is intentionally KEPT — see
    # docstring (closed-TE preservation, reference main.py:173-179).
    return merged, fixes
