"""Synthetic benchmark corpus generator.

(A copy of ``airfoil_tpu/bench/corpus.py``, kept so that the port imports
nothing of the JAX package; its files are byte-equal to the reference's
for the same ``n`` and ``seed``.)

The reference benchmark downloads the 1,000-airfoil UIUC database
(airfoil_parser_benchmark.py:171-288); where there is no network, the
corpus generator synthesises a deterministic population of
``.dat`` files reproducing the difficulty classes observed in the
reference's result data (benchmark/repair_classification.csv aggregates:
630 Lednicer, 598 LE-dup, 630 range-filter/line-skip, plus the
failure-class tail of multi-element / non-monotone / extreme-geometry
files). Point a real UIUC directory at the benchmark CLI to run on the
genuine database instead.

The GEOMETRY population deliberately goes beyond clean NACA4 sections —
the classes the reference actually struggled with are hard shapes, not
hard formatting: 6-series-style sections with a = 0.8 loading and closed
trailing edges, reflexed camber lines, blunt/thick trailing edges,
high-camber low-Re sections, very thick and very thin sections, kinked
flap-like camber, and digitisation noise at the magnitudes real UIUC
scans carry (up to ~1e-3 of chord), all at real point densities (many
UIUC files have 25-61 points/side, not 160).
"""

from __future__ import annotations

import os

import numpy as np

from airfoil_tpu_torch.models import naca4

__all__ = ["generate_corpus"]


def _selig_lines(coords, header=None, fmt="{:.6f} {:.6f}"):
    lines = [] if header is None else [header]
    lines += [fmt.format(x, y) for x, y in coords]
    return lines


def _lednicer_lines(coords, header="LEDNICER STYLE", dup_le=True,
                    counts_style=" {nu}.  {nl}.", sep="  "):
    """Two LE->TE sections with point counts, UIUC Lednicer style.

    ``counts_style``/``sep`` reproduce real formatting variation: integer
    vs float counts, tabs vs spaces, varying blank-line placement.
    """
    le = int(np.argmin(coords[:, 0]))
    upper = coords[: le + 1][::-1]
    lower = coords[le:] if dup_le else coords[le + 1:]
    lines = [header, "",
             counts_style.format(nu=len(upper), nl=len(lower)), ""]
    lines += [f" {x:.5f}{sep}{y:.5f}" for x, y in upper]
    lines.append("")
    lines += [f" {x:.5f}{sep}{y:.5f}" for x, y in lower]
    return lines


# ── hard geometry families ──────────────────────────────────────────────


def _camber_a08(x, cli):
    """NACA 6-series style a = 0.8 mean line (simplified Abbott-von
    Doenhoff form), design lift coefficient ``cli``."""
    a = 0.8
    x = np.clip(x, 1e-6, 1.0 - 1e-6)
    g = -(a * a * (0.5 * np.log(a) - 0.25) + 0.25) / (1.0 - a)
    h = g - (0.5 * (1.0 - a) ** 2 * np.log(1.0 - a)
             - 0.25 * (1.0 - a) ** 2) / (1.0 - a)
    t1 = 0.5 * (a - x) ** 2 * np.log(np.abs(a - x) + 1e-9)
    t2 = 0.5 * (1.0 - x) ** 2 * np.log(1.0 - x)
    t3 = 0.25 * (1.0 - x) ** 2 - 0.25 * (a - x) ** 2
    yc = (cli / (2.0 * np.pi * (a + 1.0))) * (
        (t1 - t2 + t3) / (1.0 - a) - x * np.log(x) + g - h * x)
    return yc


def _reflex_camber(x, m, xr=0.75):
    """Reflexed mean line: positive forward camber, negative aft."""
    fwd = m * (x / xr) ** 2 * (3.0 - 2.0 * (x / xr))
    aft = m * (1.0 - ((x - xr) / (1.0 - xr)) ** 2 * 1.8)
    return np.where(x < xr, fwd, np.maximum(aft, -0.4 * m))


def _thickness4(x, t):
    return 5.0 * t * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x**2
                      + 0.2843 * x**3 - 0.1036 * x**4)


def _section(x, yc, yt, close_te=False, te_gap=0.0):
    """Assemble a Selig loop from camber + thickness samples."""
    if close_te:
        yt = yt - x * yt[-1]
    if te_gap > 0.0:
        yt = yt + 0.5 * te_gap * x
    up = np.stack([x, yc + yt], axis=1)[::-1]
    lo = np.stack([x, yc - yt], axis=1)
    return np.vstack([up, lo[1:]])


def _hard_geometry(rng):
    """Sample one geometry from the hard-family mix; returns (coords,
    family-tag)."""
    n = int(rng.integers(24, 62))
    beta = np.pi * np.arange(n + 1) / n
    x = 0.5 * (1.0 - np.cos(beta))
    u = rng.random()
    if u < 0.25:                                   # 6-series style
        t = rng.uniform(0.08, 0.21)
        cli = rng.uniform(0.0, 0.6)
        coords = _section(x, _camber_a08(x, cli), _thickness4(x, t),
                          close_te=True)
        tag = "six_series"
    elif u < 0.40:                                 # reflexed
        t = rng.uniform(0.08, 0.16)
        m = rng.uniform(0.01, 0.05)
        coords = _section(x, _reflex_camber(x, m), _thickness4(x, t))
        tag = "reflexed"
    elif u < 0.55:                                 # thick blunt TE
        t = rng.uniform(0.10, 0.24)
        mm = rng.uniform(0, 4)
        pp = rng.uniform(2, 6)
        base = naca4(mm, pp, 100 * t, n)
        base[0, 1] += rng.uniform(0.004, 0.012)    # open the TE
        base[-1, 1] -= rng.uniform(0.004, 0.012)
        coords = base
        tag = "thick_te"
    elif u < 0.70:                                 # high camber low-Re
        t = rng.uniform(0.06, 0.12)
        m = rng.uniform(0.06, 0.11)
        p = rng.uniform(0.3, 0.55)
        yc = np.where(x < p, m / p**2 * (2 * p * x - x**2),
                      m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * x - x**2))
        coords = _section(x, yc, _thickness4(x, t))
        tag = "high_camber"
    elif u < 0.82:                                 # extreme thickness
        thin = rng.random() < 0.5
        t = rng.uniform(0.035, 0.055) if thin else rng.uniform(0.25, 0.36)
        coords = _section(x, np.zeros_like(x), _thickness4(x, t))
        tag = "very_thin" if thin else "very_thick"
    else:                                          # kinked flap-like
        t = rng.uniform(0.08, 0.15)
        m = rng.uniform(0.01, 0.04)
        xh = rng.uniform(0.6, 0.8)
        d = rng.uniform(0.03, 0.10)
        yc = m * 4.0 * x * (1.0 - x) - np.where(
            x > xh, d * (x - xh) / (1.0 - xh) * (x - xh), 0.0)
        coords = _section(x, yc, _thickness4(x, t))
        tag = "kinked"
    return coords, tag


def _hard_lednicer_lines(coords, rng):
    """Adversarial Lednicer variants built from the reference's measured
    hard cases (its 142 both-failed files include Lednicer files its own
    parser could not rescue — benchmark/failure_classification.csv): no
    counts line at all (sections split by blank lines only), lower section
    FIRST, counts lines with parenthetical text, and three-column rows
    (x y station-index) that must still parse as coordinate pairs."""
    le = int(np.argmin(coords[:, 0]))
    upper = coords[: le + 1][::-1]
    lower = coords[le:]
    u = rng.random()
    if u < 0.35:
        # No counts line: two LE->TE blocks separated by a blank line.
        lines = ["UIUC-STYLE NO-COUNTS", ""]
        lines += [f" {x:.5f}  {y:.5f}" for x, y in upper]
        lines.append("")
        lines += [f" {x:.5f}  {y:.5f}" for x, y in lower]
        return lines, "lednicer_nocounts"
    if u < 0.60:
        # Counts line with trailing text (real UIUC files carry comments).
        lines = [f"SECTION ({len(upper)} upper, {len(lower)} lower pts)",
                 "", f" {len(upper)}.  {len(lower)}.   (see note)", ""]
        lines += [f" {x:.5f}  {y:.5f}" for x, y in upper]
        lines.append("")
        lines += [f" {x:.5f}  {y:.5f}" for x, y in lower]
        return lines, "lednicer_comment"
    # Three-column rows: x y index.
    lines = ["THREE COLUMN EXPORT", "", f" {len(upper)}.  {len(lower)}.", ""]
    lines += [f" {x:.5f} {y:.5f} {i + 1}" for i, (x, y) in enumerate(upper)]
    lines.append("")
    lines += [f" {x:.5f} {y:.5f} {i + 1}" for i, (x, y) in enumerate(lower)]
    return lines, "lednicer_3col"


def generate_corpus(out_dir: str, n: int = 500, seed: int = 0) -> list[str]:
    """Write ``n`` synthetic .dat files; returns the file paths.

    Formatting population (matching the reference's observed class mix,
    scaled): ~42% Lednicer with real formatting variation, ~8% adversarial
    hard-Lednicer (no counts line / annotated counts / 3-column rows),
    ~18% clean Selig, ~12% Selig with digitisation noise/headers/stray
    points, ~4.5% reversed winding, ~2% closed-TE, ~10.5% multi-element
    (matching the reference's corpus share, 105/1000, its dominant
    both-failed class — in three observed formats: bare concatenation,
    blank-line separated, per-element sub-headers), ~3% degenerate
    (too few points / non-monotone). Geometry alternates between NACA4
    variants and the hard families above.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n):
        name = f"af{i:04d}"
        if rng.random() < 0.45:
            m = rng.uniform(0, 6)
            p = rng.uniform(2, 6)
            t = rng.uniform(6, 21)
            npt = int(rng.integers(25, 80))
            coords = naca4(m, p, t, npt)
            geo = "naca4"
        else:
            coords, geo = _hard_geometry(rng)

        # Digitisation noise at real scan magnitudes on a subset.
        if rng.random() < 0.30:
            coords = coords.copy()
            coords[:, 1] += rng.normal(0, rng.uniform(1e-4, 8e-4),
                                       len(coords))

        u = rng.random()
        if u < 0.42:
            style = rng.random()
            counts = (" {nu}.  {nl}." if style < 0.5 else
                      "{nu} {nl}" if style < 0.75 else "  {nu}.0 {nl}.0")
            sep = "\t" if rng.random() < 0.2 else "  "
            header = (f"NACA 64(3)-{int(rng.integers(100, 999))}"
                      if rng.random() < 0.3 else f"{name.upper()} AIRFOIL")
            lines = _lednicer_lines(coords, header=header,
                                    dup_le=rng.random() < 0.7,
                                    counts_style=counts, sep=sep)
            kind = "lednicer"
        elif u < 0.50:
            lines, kind = _hard_lednicer_lines(coords, rng)
        elif u < 0.68:
            lines = _selig_lines(coords, header=f"{name} section")
            kind = "selig"
        elif u < 0.80:
            noisy = coords.copy()
            noisy[:, 1] += rng.normal(0, 2e-4, len(noisy))
            lines = _selig_lines(noisy, header=f"{name} (noisy)")
            lines.insert(1, "# comment line")
            lines.append(f"{rng.uniform(5, 9):.3f} {rng.uniform(2, 4):.3f}")
            kind = "noisy"
        elif u < 0.845:
            lines = _selig_lines(coords[::-1], header=f"{name} reversed")
            kind = "reversed"
        elif u < 0.865:
            closed = np.vstack([coords, coords[:1]])
            closed[0, 1] = closed[-1, 1] = 0.0
            closed[0, 0] = closed[-1, 0] = 1.0
            lines = _selig_lines(closed, header=f"{name} closed TE")
            kind = "closed_te"
        elif u < 0.97:
            # Multi-element at the reference's share (105/1000 of its
            # UIUC corpus, the dominant both-failed class) and in its
            # observed formats: elements concatenated bare (the classic
            # "non-monotone because it is a flap" signature), separated
            # by a blank line, or each with its own sub-header line.
            flap = coords * 0.35 + np.array([1.05, -0.05])
            parts = [coords, flap]
            if rng.random() < 0.4:
                slat = coords * 0.15 + np.array([-0.17, -0.02])
                parts.insert(0, slat)
            style = rng.random()
            if style < 0.4:
                lines = _selig_lines(np.vstack(parts),
                                     header=f"{name} multi-element")
            elif style < 0.75:
                lines = [f"{name.upper()} MULTI-ELEMENT SECTION"]
                for part in parts:
                    lines.extend(_selig_lines(part)[1:])
                    lines.append("")
                while lines and not lines[-1]:
                    lines.pop()
            else:
                lines = [f"{name.upper()} WITH FLAP"]
                for j, part in enumerate(parts):
                    lines.append(f"ELEMENT {j + 1}")
                    lines.extend(_selig_lines(part)[1:])
            kind = "multi"
        else:
            if rng.random() < 0.5:
                lines = _selig_lines(coords[:5], header=f"{name} truncated")
                kind = "too_few"
            else:
                shuffled = coords.copy()
                rng.shuffle(shuffled[5:-5])
                lines = _selig_lines(shuffled, header=f"{name} scrambled")
                kind = "non_monotone"
        path = os.path.join(out_dir, f"{name}_{geo}_{kind}.dat")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(path)
    return paths
