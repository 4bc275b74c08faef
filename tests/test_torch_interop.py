"""The port's XFOIL interop (``airfoil_tpu_torch.interop``) and its parity
harness's live-XFOIL truth, against the JAX package's.

Every case of ``tests/test_interop.py`` runs on both packages (the same
assertions) and the two outputs must be equal. ``run_xfoil_if_available``
drives a fake ``xfoil``: an executable Python script written into
``tmp_path`` and named by ``XFOIL_PATH``, which reads the command script on
stdin, writes the ``CPWR`` and ``DUMP`` files it names and prints a
coefficient block computed from the loaded geometry, alpha and Re; its
variants converge, print ``VISCAL:  Convergence failed``, leave out the
``CPWR`` file, or sleep past the caller's timeout. Both packages must
return equal tuples, or both ``None``; with no binary both return ``None``.
``run_parity`` of both packages, with their polar solves scripted to the
same answers, must give equal points and aggregates under the fake binary
(which fails from alpha 12 on, so those anchors fall back to the table),
without it, and with live truth turned off.
"""

import stat
import sys

import numpy as np
import pytest

from airfoil_tpu import interop as ref_interop
from airfoil_tpu.bench import parity as ref_parity
from airfoil_tpu_torch import interop
from airfoil_tpu_torch.bench import parity

PACKAGES = {"port": interop, "jax": ref_interop}

XFOIL_STDOUT = """
 Solving BL system ...
  a =  5.000   CL =  0.6352   CD = 0.009241   CDp = 0.007812   Cm = -0.0521
 VISCAL:  Convergence achieved in 12 iterations
"""
TWO_BLOCKS = """
  a =  5.000   CL =  0.5000   CD = 0.010000   CDp = 0.008000   Cm = -0.050
  a =  5.000   CL =  0.6352   CD = 0.009241   CDp = 0.007812   Cm = -0.0521
        """
NEGATIVE = "  CL = -0.3214   CD = 0.011200   CDp = 0.009100   Cm =  0.0312"
ZERO = "  CL =  0.0000   CD = 0.006500   CDp = 0.005200   Cm =  0.0000"
DUMP = (
    "   0.000   1.000   0.001   0.950   0.0040   0.0020   0.00300  1.50\n"
    "   0.100   0.900   0.010   1.050   0.0030   0.0015   0.00100  2.10\n"
    "   0.200   0.800   0.020   1.100   0.0020   0.0010   0.00030  2.59\n"
    "   0.300   0.700   0.030   1.120   0.0018   0.0009   0.00090  1.60\n"
    "   0.400   0.600   0.035   1.130   0.0019   0.0010   0.00095  1.55\n"
    "\n"
    "   0.000   0.000   0.000   0.500   0.0001   0.0001   0.01000  2.20\n"
    "   0.500   0.500  -0.020   1.000   0.0010   0.0006   0.00200  2.40\n"
    "   0.900   0.950  -0.005   0.950   0.0030   0.0015   0.00150  1.70\n"
)


def _both(fn_name, *args, **kwargs):
    """(port output, reference output) of one interop function."""
    return (getattr(interop, fn_name)(*args, **kwargs),
            getattr(ref_interop, fn_name)(*args, **kwargs))


# ── tests/test_interop.py's cases, on both packages ─────────────────────────

@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_extracts_all(pkg):
    c = PACKAGES[pkg].extract_aerodynamic_coefficients(XFOIL_STDOUT)
    assert abs(c["CL"] - 0.6352) < 1e-4
    assert abs(c["CD"] - 0.009241) < 1e-6
    assert abs(c["CDp"] - 0.007812) < 1e-6
    assert abs(c["Cm"] - (-0.0521)) < 1e-4
    assert c == ref_interop.extract_aerodynamic_coefficients(XFOIL_STDOUT)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_takes_last_occurrence(pkg):
    c = PACKAGES[pkg].extract_aerodynamic_coefficients(TWO_BLOCKS)
    assert abs(c["CL"] - 0.6352) < 1e-4
    assert c == ref_interop.extract_aerodynamic_coefficients(TWO_BLOCKS)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_empty_on_no_match(pkg):
    assert PACKAGES[pkg].extract_aerodynamic_coefficients(
        "XFOIL Version 6.99\n") == {}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_negative_cl(pkg):
    c = PACKAGES[pkg].extract_aerodynamic_coefficients(NEGATIVE)
    assert c["CL"] < 0
    assert c == ref_interop.extract_aerodynamic_coefficients(NEGATIVE)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_zero_alpha(pkg):
    c = PACKAGES[pkg].extract_aerodynamic_coefficients(ZERO)
    assert abs(c["CL"]) < 1e-4
    assert c == ref_interop.extract_aerodynamic_coefficients(ZERO)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_cp_file(pkg, tmp_path):
    p = tmp_path / "cp.txt"
    p.write_text("#  x        Cp\n 1.00000   0.20000\n 0.50000  -0.80000\n"
                 "garbage line\n 0.00000   1.00000\n")
    x, cp = PACKAGES[pkg].parse_cp_file(str(p))
    assert x == [1.0, 0.5, 0.0]
    assert cp == [0.2, -0.8, 1.0]
    assert (x, cp) == ref_interop.parse_cp_file(str(p))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_bl_sections_and_columns(pkg, tmp_path):
    p = tmp_path / "bl.txt"
    p.write_text(DUMP)
    bl = PACKAGES[pkg].parse_bl_dump(str(p))
    assert len(bl["upper"]) == 5
    assert len(bl["lower"]) == 3
    row = bl["upper"][0]
    assert row["x"] == 1.0 and row["dstar"] == 0.004
    assert row["H"] == 1.5
    assert bl == ref_interop.parse_bl_dump(str(p))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_transition_detected_from_cf_jump(pkg, tmp_path):
    p = tmp_path / "bl.txt"
    p.write_text(DUMP)
    bl = PACKAGES[pkg].parse_bl_dump(str(p))
    # upper: cf jumps 0.0003 -> 0.0009 (x3) at x=0.7
    assert bl["transition_upper_x"] == 0.7


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_missing_bl_file(pkg):
    assert PACKAGES[pkg].parse_bl_dump("/no/such/file") is None


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_viscous_script(pkg):
    args = ("airfoil.dat", "cp.txt", "bl.txt", 1e6, 5.0)
    kw = dict(viscous=True, smooth_geometry=True)
    s = PACKAGES[pkg].write_xfoil_script(*args, **kw)
    lines = s.splitlines()
    assert lines[0] == "LOAD airfoil.dat"
    assert "PANE" in lines
    assert "GDES" in lines and "SMOO" in lines
    assert "VISC 1000000" in lines
    assert "ITER 500" in lines
    assert "ALFA 5.0" in lines
    assert "DUMP bl.txt" in lines
    assert lines[-1] == "QUIT"
    assert s == ref_interop.write_xfoil_script(*args, **kw)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_inviscid_script(pkg):
    args = ("a.dat", "cp.txt", "bl.txt", 1e6, 2.0)
    s = PACKAGES[pkg].write_xfoil_script(*args, viscous=False)
    assert "VISC" not in s and "DUMP" not in s
    assert s == ref_interop.write_xfoil_script(*args, viscous=False)


# ── the parsers on seeded files ─────────────────────────────────────────────

@pytest.mark.parametrize("seed", range(4))
def test_parsers_on_seeded_files(seed, tmp_path):
    """Seeded CPWR and DUMP files with headers, malformed rows, short rows,
    7-column rows and blank-line sections: the same lists and dicts."""
    rng = np.random.default_rng(seed)
    cp_lines = ["#  x        Cp"]
    for _ in range(int(rng.integers(5, 40))):
        r = rng.random()
        if r < 0.1:
            cp_lines.append("garbage line")
        elif r < 0.15:
            cp_lines.append(" 0.5")
        elif r < 0.2:
            cp_lines.append(" 1.0 -- ")
        else:
            cp_lines.append(f" {rng.random():.5f} {rng.normal():.5f}")
    (tmp_path / "cp.txt").write_text("\n".join(cp_lines) + "\n")
    got, want = _both("parse_cp_file", str(tmp_path / "cp.txt"))
    assert got == want
    dump = []
    for _ in range(int(rng.integers(1, 4))):
        for _ in range(int(rng.integers(2, 12))):
            vals = rng.random(8) * [1, 1, 0.1, 1.2, 0.01, 0.005, 0.01, 3]
            cols = int(rng.choice([6, 7, 8, 8, 8]))
            dump.append(" ".join(f"{v:.5f}" for v in vals[:cols]))
        dump.append("")
    (tmp_path / "bl.txt").write_text("\n".join(dump))
    got, want = _both("parse_bl_dump", str(tmp_path / "bl.txt"))
    assert got == want


# ── run_xfoil_if_available against a fake binary ────────────────────────────

_FAKE = r'''#!{python} -S
import os, sys, time
variant = {variant!r}
load = cp_name = dump_name = None
alpha = re_ = 0.0
for line in sys.stdin.read().splitlines():
    w = line.split()
    if not w:
        continue
    if w[0] == "LOAD":
        load = w[1]
    elif w[0] == "VISC":
        re_ = float(w[1])
    elif w[0] == "ALFA":
        alpha = float(w[1])
    elif w[0] == "CPWR":
        cp_name = w[1]
    elif w[0] == "DUMP":
        dump_name = w[1]
if variant == "sleep":
    time.sleep(30)
ys = []
with open(load) as f:
    for line in f:
        p = line.split()
        try:
            ys.append(float(p[1]))
        except (IndexError, ValueError):
            pass
camber = (max(ys) + min(ys)) / 2
cl = 0.1097 * alpha + 8.0 * camber
cd = 0.0052 + 1.1e-4 * alpha * alpha + 2.0e3 / max(re_, 1.0)
if cp_name and variant != "no_cpwr":
    with open(cp_name, "w") as f:
        f.write("#    x        Cp  \n")
        for i in range(11):
            x = 1.0 - i / 10
            f.write(f"  {{x:.5f}}  {{1.0 - (1 + 0.1 * alpha) * x * (2 - x):.5f}}\n")
if dump_name:
    with open(dump_name, "w") as f:
        for side in (1, -1):
            for i in range(6):
                cf = 0.004 if i > 2 + side else 0.001
                x = i / 5
                f.write(f" {{i / 5:.4f}} {{x:.4f}} {{0.05 * side:.4f}} 1.0 "
                        f"{{0.001 * i:.5f}} {{0.0005 * i:.5f}} {{cf:.5f}} 2.1\n")
            f.write("\n")
print(" XFOIL fake")
print(f"  a = {{alpha:6.3f}}   CL = {{cl:7.4f}}   CD = {{cd:8.6f}}"
      f"   CDp = {{cd / 2:8.6f}}   Cm = {{-0.02 * camber:7.4f}}")
if variant == "failed" or (variant == "parity" and alpha >= 12):
    print(" VISCAL:  Convergence failed")
else:
    print(" VISCAL:  Convergence achieved in 9 iterations")
'''


def _fake_xfoil(tmp_path, variant: str) -> str:
    path = tmp_path / f"xfoil_{variant}"
    path.write_text(_FAKE.format(python=sys.executable, variant=variant))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _coords_file(tmp_path) -> str:
    from airfoil_tpu_torch.models import naca4
    path = tmp_path / "naca2412.dat"
    path.write_text("naca2412\n" + "".join(
        f" {x:.6f} {y:.6f}\n" for x, y in naca4(2, 4, 12, 60)))
    return str(path)


@pytest.mark.parametrize("viscous", [True, False])
@pytest.mark.parametrize("variant", ["converged", "failed", "no_cpwr",
                                     "sleep"])
def test_run_xfoil_fake_binary(variant, viscous, tmp_path, monkeypatch):
    monkeypatch.setenv("XFOIL_PATH", _fake_xfoil(tmp_path, variant))
    coords = _coords_file(tmp_path)
    got, want = (
        pkg.run_xfoil_if_available(coords, 1e6, 5.0, str(tmp_path / name),
                                   timeout=1, viscous=viscous)
        for name, pkg in (("port", interop), ("jax", ref_interop)))
    assert got == want
    if variant == "converged":
        coeffs, cp_x, cp, bl = got
        assert set(coeffs) == {"CL", "CD", "CDp", "Cm"}
        assert len(cp_x) == len(cp) == 11
        assert (bl is not None) == viscous
        if viscous:
            assert bl["transition_upper_x"] is not None
    else:
        assert got is None


def test_run_xfoil_no_binary(tmp_path, monkeypatch):
    monkeypatch.setenv("XFOIL_PATH", str(tmp_path / "no_xfoil_here"))
    coords = _coords_file(tmp_path)
    for pkg in (interop, ref_interop):
        assert pkg.run_xfoil_if_available(coords, 1e6, 5.0,
                                          str(tmp_path / "wd")) is None


# ── run_parity's truth, both packages ───────────────────────────────────────

def _answer(name, re_, alpha):
    """A scripted polar point: (cl, cd, converged)."""
    rng = np.random.default_rng(int(alpha * 10) + int(re_ / 1e5))
    cl = 0.1 * alpha + {"naca0012": 0.0, "naca2412": 0.25,
                        "naca4412": 0.5}[name] + 0.02 * rng.normal()
    cd = 0.008 * (1.0 + 0.3 * rng.random()) + 2e-4 * alpha
    return float(cl), float(cd), bool(alpha <= 12.0)


def _timing(name, re_, alphas):
    return {"airfoil": name, "reynolds": re_, "points": len(alphas),
            "seconds": 0.0}


@pytest.fixture
def scripted(monkeypatch):
    """Both packages' polar solves scripted to the same answers."""
    monkeypatch.setattr(ref_parity, "_solve_polar_points",
                        lambda name, re_, alphas: {
                            a: _answer(name, re_, a) for a in alphas})
    monkeypatch.setattr(parity, "_solve_polar_points",
                        lambda name, re_, alphas, device: (
                            {a: _answer(name, re_, a) for a in alphas},
                            _timing(name, re_, alphas)))


@pytest.mark.parametrize("truth", ["fake_binary", "no_binary", "off"])
def test_run_parity_truth(truth, scripted, tmp_path, monkeypatch):
    if truth == "no_binary":
        monkeypatch.setenv("XFOIL_PATH", str(tmp_path / "no_xfoil_here"))
    else:
        monkeypatch.setenv("XFOIL_PATH", _fake_xfoil(tmp_path, "parity"))
    live = truth != "off"
    got = parity.run_parity(use_live_xfoil=live, device="cpu")
    want = ref_parity.run_parity(use_live_xfoil=live)
    assert got["points"] == want["points"]
    for key, value in want.items():
        assert got[key] == value, key
    sources = {p["truth_source"] for p in got["points"]}
    if truth == "fake_binary":
        # The fake converges below alpha 12: live truth there, the table
        # from alpha 12 on.
        assert sources == {"xfoil_binary", "vendored_table"}
        assert got["ground_truth"] == "live xfoil"
        for p in got["points"]:
            live_point = p["truth_source"] == "xfoil_binary"
            assert live_point == (p["alpha"] < 12.0)
            if live_point:
                assert p["unc_cl"] == p["unc_cd_rel"] == 0.0
    else:
        assert sources == {"vendored_table"}
        assert got["ground_truth"].startswith("vendored dataset")
    assert got["device"] == "cpu"
    groups = {(p["airfoil"], p["reynolds"]) for p in got["points"]}
    assert [(t["airfoil"], t["reynolds"]) for t in got["timing"]] == \
        list(dict.fromkeys((p["airfoil"], p["reynolds"])
                           for p in got["points"]))
    assert len(got["timing"]) == len(groups)
