"""The port's native geometry library (``airfoil_tpu_torch.native``)
against the port's Python paths and the reference's native library.

``fastgeo.cpp`` is a byte copy of the reference's source, built into
``airfoil_tpu_torch/_build/`` and nowhere beside it. Its parse equals the
port's Python parser and the reference's native parse on the reference's
differential corpus (``generate_corpus(n=60, seed=7)``): error status and
text, coordinates and fix messages. Its mask equals the numpy scanline and
the reference's native mask element for element, and ``rasterize_airfoil``
takes it (``masks.rasteriser()`` is ``"native"``). Skipped, as the
reference's ``tests/test_native.py``, where there is no C++ toolchain.
"""

import os
import shutil

import numpy as np
import pytest

from airfoil_tpu.bench.corpus import generate_corpus
from airfoil_tpu.geometry import AirfoilParseError as RefParseError
from airfoil_tpu.native import parse_dat_native as ref_parse_native
from airfoil_tpu.native import raster_mask_native as ref_raster_native
from airfoil_tpu_torch import cuda_build, native
from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.geometry import AirfoilParseError, parse_dat_text
from airfoil_tpu_torch.lbm import masks
from airfoil_tpu_torch.models import naca4

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain in this environment")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "airfoil_tpu_torch", "native")


def _outcome(fn, text, error):
    try:
        coords, fixes = fn(text)
    except error as e:
        return "error", e.detail, None
    return "ok", fixes, np.asarray(coords)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n=60,
                           seed=7)


def test_source_is_a_copy():
    ref = os.path.join(ROOT, "airfoil_tpu", "native", "fastgeo.cpp")
    with open(native._SRC, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_library_lands_in_the_build_directory():
    assert native.native_available()
    lib = os.path.join(cuda_build.BUILD_DIR, "libfastgeo.so")
    assert native.get_lib()._name == lib and os.path.exists(lib)
    with open(os.path.join(cuda_build.BUILD_DIR, "libfastgeo.flags")) as fh:
        assert fh.read() == " ".join(native.GXX_FLAGS)
    assert [f for f in os.listdir(NATIVE_DIR)
            if not f.endswith((".py", ".cpp")) and f != "__pycache__"] == []


def test_rasteriser_is_native():
    assert masks.rasteriser() == "native"


@pytest.mark.parametrize("half", [0, 1])
def test_parse_corpus(corpus, half):
    """Each corpus file: the port's native parse equals its Python parser
    (the source of truth) and the reference's native parse."""
    mismatches = []
    for path in corpus[half::2]:
        with open(path, errors="ignore") as fh:
            text = fh.read()
        got = _outcome(native.parse_dat_native, text, AirfoilParseError)
        py = _outcome(parse_dat_text, text, AirfoilParseError)
        ref = _outcome(ref_parse_native, text, RefParseError)
        for name, other in (("python", py), ("reference native", ref)):
            if got[:2] != other[:2]:
                mismatches.append((os.path.basename(path), name, got[:2],
                                   other[:2]))
            elif got[0] == "ok" and not np.array_equal(got[2], other[2]):
                mismatches.append((os.path.basename(path), name, "coords"))
    assert not mismatches, mismatches[:3]


def test_parse_error_message():
    text = "junk\n0.5 0.1\n0.4 0.05\n"
    with pytest.raises(AirfoilParseError) as py:
        parse_dat_text(text)
    with pytest.raises(AirfoilParseError) as nat:
        native.parse_dat_native(text)
    assert str(py.value) == str(nat.value)
    assert nat.value.code == "too_few_points" and nat.value.status_code == 400


@pytest.mark.parametrize("alpha", [-7.5, 6.0, 18.0])
@pytest.mark.parametrize("grid", [(384, 192), (250, 130)])
def test_mask(alpha, grid):
    """Native against the numpy scanline and the reference's native
    raster on the same float64 panel points, element for element, and
    ``rasterize_airfoil`` returns it."""
    cfg = LBMConfig(nx=grid[0], ny=grid[1])
    coords = naca4(2, 4, 12, 60)
    xp, yp = masks._panelise(masks._rotate(np.asarray(coords, np.float64),
                                           alpha))
    domain = (cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1)
    got = native.raster_mask_native(xp, yp, cfg.nx, cfg.ny, domain)
    assert got.dtype == np.float32 and got.shape == (cfg.ny, cfg.nx)
    assert 0 < got.sum() < cfg.nx * cfg.ny
    np.testing.assert_array_equal(
        got, masks.raster_mask_numpy(xp, yp, cfg.nx, cfg.ny, domain))
    np.testing.assert_array_equal(
        got, ref_raster_native(xp, yp, cfg.nx, cfg.ny, domain))
    np.testing.assert_array_equal(got, masks.rasterize_airfoil(coords, alpha,
                                                               cfg))


def test_without_gxx_the_numpy_scanline(monkeypatch):
    """No g++ and no library loaded: no native path, and the mask is the
    numpy scanline's."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_gxx", lambda: None)
    assert not native.native_available()
    assert native.parse_dat_native("x") is None
    assert masks.rasteriser() == "numpy"
    cfg = LBMConfig(nx=128, ny=64)
    coords = naca4(0, 0, 12, 50)
    xp, yp = masks._panelise(masks._rotate(np.asarray(coords, np.float64),
                                           4.0))
    np.testing.assert_array_equal(
        masks.rasterize_airfoil(coords, 4.0, cfg),
        masks.raster_mask_numpy(xp, yp, cfg.nx, cfg.ny,
                                (cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1)))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails: the build raises with its output, and no
    library is left behind."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed \(exit 1\) "
                                           r"building badgeo"):
        cuda_build.build_library("badgeo", lambda: "g++", native.GXX_FLAGS,
                                 [str(bad)], headers=[])
    assert not os.path.exists(tmp_path / "build" / "libbadgeo.so")
