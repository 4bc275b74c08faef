"""The port stands alone: ``airfoil_tpu_torch`` and ``chip_smoke.py`` import
nothing of ``airfoil_tpu`` and no JAX, and the copies the port keeps of the
reference's jax-free modules (``config`` with ``SolverConfig``, ``geometry``,
``models``, the mask rasteriser, the static page, the analysis counter, and
the benchmark's corpus generator, UIUC marker, constants, no-repair reader
and failure/repair classifiers) equal the reference's; each package exports
the reference package's public names.

The first test runs a subprocess in which a meta-path finder refuses every
``airfoil_tpu`` and ``jax`` module; inside it every module of the port (and
every name in its ``__all__``) and ``chip_smoke`` is imported, a 64x32
``WindTunnel`` runs on the CPU, an upload is parsed, and two gloo ranks
(``parallel.launch.run``) run the sharded LBM step, each reporting that its
own process loaded neither. The others hold each copy to the reference on
the same inputs: exact values, coordinates and fix messages, and masks
element for element.
"""

import dataclasses
import glob
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from airfoil_tpu import config as ref_config
from airfoil_tpu.api import handlers as ref_handlers
from airfoil_tpu.geometry import parse_dat_text as ref_parse_dat_text
from airfoil_tpu.lbm import masks as ref_masks
from airfoil_tpu.models import naca4 as ref_naca4
from airfoil_tpu.utils import stats as ref_stats
from airfoil_tpu_torch import config
from airfoil_tpu_torch.api import handlers, minihttp
from airfoil_tpu_torch.geometry import AirfoilParseError, parse_dat_text
from airfoil_tpu_torch.lbm import masks
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.utils import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(
    ROOT, "airfoil_tpu", "bench", "results", "corpus", "*.dat")))
# The corpus file names end in their format: af0001_thick_te_lednicer.dat.
FORMATS = ("selig", "lednicer", "lednicer_3col", "lednicer_comment",
           "lednicer_nocounts", "multi", "noisy", "non_monotone", "reversed",
           "closed_te", "too_few")
# Exports of the reference that the port leaves out: the Pallas kernel,
# whose counterpart is the port's ``lbm_steps``.
NOT_EXPORTED = {"lbm": {"lbm_steps_pallas"}}
CONSTANTS = ("MAX_FILE_SIZE", "MAX_POINTS", "MIN_POINTS", "MIN_REYNOLDS",
             "MAX_REYNOLDS", "MIN_ALPHA", "MAX_ALPHA", "MAX_CONCURRENT_SOLVES",
             "PORT", "ALLOWED_ORIGINS")

_ISOLATED = r"""
import importlib, importlib.abc, json, pkgutil, sys

REFUSED = ("airfoil_tpu", "jax", "jaxlib")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None

# Forget anything the interpreter's start-up loaded, so that every import
# of a refused module reaches the finder.
for mod in list(sys.modules):
    if mod.partition(".")[0] in REFUSED:
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())

import numpy as np
import airfoil_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    airfoil_tpu_torch.__path__, "airfoil_tpu_torch."))
public = 0
for name in names:
    mod = importlib.import_module(name)
    for attr in getattr(mod, "__all__", ()):
        getattr(mod, attr)
        public += 1
import chip_smoke
from airfoil_tpu_torch.api.handlers import parse_upload
from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.lbm import WindTunnel

coords = chip_smoke.naca4_coords()
wt = WindTunnel(coords, cfg=LBMConfig(nx=64, ny=32), device="cpu")
out = wt.frame(steps=2)
dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}" for x, y in coords)
parsed, fixes = parse_upload("naca2412.dat", dat.encode())
# Two gloo ranks of the sharded LBM step: each reports the refused modules
# its own process loaded.
sys.path.insert(0, "tests")
import torch_parallel_ranks
from airfoil_tpu_torch.parallel.launch import run
child_loaded = run(torch_parallel_ranks.dryrun_rank, 2, device="cpu")
loaded = sorted(m for m in sys.modules if m.partition(".")[0] in REFUSED)
print(json.dumps({"modules": names, "loaded": loaded, "public": public,
                  "child_loaded": child_loaded,
                  "finite": bool(np.isfinite([out["cl"], out["cd"]]).all()),
                  "step": out["step"], "points": len(parsed),
                  "fixes": fixes}))
"""


def _run(code: str, env=None) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_nothing_of_the_reference():
    got = _run(_ISOLATED)
    assert got["loaded"] == [] and got["child_loaded"] == []
    for mod in ("airfoil_tpu_torch.config", "airfoil_tpu_torch.geometry.parser",
                "airfoil_tpu_torch.models.naca", "airfoil_tpu_torch.lbm.masks",
                "airfoil_tpu_torch.api.minihttp",
                "airfoil_tpu_torch.viscous.kernel",
                "airfoil_tpu_torch.polar.sweep",
                "airfoil_tpu_torch.polar.batch",
                "airfoil_tpu_torch.bench.parity",
                "airfoil_tpu_torch.bench.parser_benchmark",
                "airfoil_tpu_torch.bench.corpus",
                "airfoil_tpu_torch.bench.uiuc",
                "airfoil_tpu_torch.bench.classify_failures",
                "airfoil_tpu_torch.bench.classify_repairs",
                "airfoil_tpu_torch.bench.paneling_probe",
                "airfoil_tpu_torch.inviscid.flowfield",
                "airfoil_tpu_torch.parallel.mesh",
                "airfoil_tpu_torch.parallel.launch",
                "airfoil_tpu_torch.lbm.sharded",
                "airfoil_tpu_torch.graft_entry",
                "airfoil_tpu_torch.models.joukowski",
                "airfoil_tpu_torch.interop",
                "airfoil_tpu_torch.interop.xfoil",
                "airfoil_tpu_torch.utils.profiling",
                "airfoil_tpu_torch.ui.flowviz",
                "airfoil_tpu_torch.bench.headline",
                "airfoil_tpu_torch.utils.compile_cache",
                "airfoil_tpu_torch.viscous.graphs"):
        assert mod in got["modules"]
    assert got["public"] > 0
    assert got["finite"] and got["step"] == 2
    dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                    for x, y in ref_naca4(2, 4, 12, 60))
    coords, fixes = ref_handlers.parse_upload("naca2412.dat", dat.encode())
    assert (got["points"], got["fixes"]) == (len(coords), fixes)


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constant(name):
    assert getattr(config, name) == getattr(ref_config, name)
    assert type(getattr(config, name)) is type(getattr(ref_config, name))


def test_config_environment():
    env = dict(os.environ, PORT="8123", AIRFOIL_TPU_MAX_CONCURRENT="5",
               ALLOWED_ORIGINS="https://a.example,https://b.example")
    code = ("import json\nfrom airfoil_tpu import config as r\n"
            "from airfoil_tpu_torch import config as p\n"
            f"names = {list(CONSTANTS)!r}\n"
            "print(json.dumps([[getattr(p, n), getattr(r, n)] for n in names]))")
    pairs = _run(code, env)
    assert [p for p, _ in pairs] == [r for _, r in pairs]
    assert pairs[CONSTANTS.index("PORT")][0] == 8123


def test_solver_config():
    fields = [(f.name, f.default)
              for f in dataclasses.fields(config.SolverConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(ref_config.SolverConfig)]
    assert fields == want
    assert dataclasses.asdict(config.DEFAULT_SOLVER) == \
        dataclasses.asdict(ref_config.DEFAULT_SOLVER)
    assert config.SolverConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("package", ["api", "bench", "geometry", "interop",
                                     "inviscid", "lbm", "models", "paneling",
                                     "parallel", "polar", "utils",
                                     "viscous"])
def test_package_exports(package):
    """Every name a reference package exports, the port's exports too, but
    for ``NOT_EXPORTED``."""
    import importlib
    ref = importlib.import_module(f"airfoil_tpu.{package}")
    port = importlib.import_module(f"airfoil_tpu_torch.{package}")
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == NOT_EXPORTED.get(package, set()), missing
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_lbm_config():
    fields = [(f.name, f.default) for f in dataclasses.fields(config.LBMConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(ref_config.LBMConfig)]
    assert fields == want
    for cfg, ref in ((config.DEFAULT_LBM, ref_config.DEFAULT_LBM),
                     (config.LBMConfig(nx=2048, ny=1024, tau=0.55),
                      ref_config.LBMConfig(nx=2048, ny=1024, tau=0.55))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert (cfg.nu, cfg.chord_cells) == (ref.nu, ref.chord_cells)


def _files_of(fmt: str) -> list[str]:
    return [p for p in CORPUS
            if os.path.basename(p).endswith(f"_{fmt}.dat")
            and not any(os.path.basename(p).endswith(f"_{other}.dat")
                        for other in FORMATS
                        if other != fmt and other.endswith(f"_{fmt}"))]


def _parse(fn, text):
    try:
        return fn(text)
    except Exception as e:                       # noqa: BLE001
        return type(e).__name__, getattr(e, "status_code", None), \
            getattr(e, "detail", str(e))


@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_dat_text_corpus(fmt):
    """Every corpus file of one format: the same coordinates and fix
    messages (or the same refusal), and ``parse_upload`` the same."""
    files = _files_of(fmt)
    assert files
    for path in files:
        with open(path, "rb") as fh:
            content = fh.read()
        text = content.decode("utf-8", errors="ignore")
        got, want = _parse(parse_dat_text, text), _parse(ref_parse_dat_text,
                                                        text)
        assert got == want, os.path.basename(path)
        name = os.path.basename(path)
        up = _parse(lambda t: handlers.parse_upload(name, content), None)
        ref_up = _parse(lambda t: ref_handlers.parse_upload(name, content),
                        None)
        assert up == ref_up, name


def test_parse_error_type():
    with pytest.raises(AirfoilParseError) as err:
        parse_dat_text("not an airfoil\n1 2\n")
    assert err.value.status_code == 400


@pytest.mark.parametrize("section", [(0, 0, 12, 50), (2, 4, 12, 100),
                                     (4, 4, 12, 60), (6, 4, 9, 80)])
@pytest.mark.parametrize("closed_te", [False, True])
def test_naca4(section, closed_te):
    np.testing.assert_array_equal(naca4(*section, closed_te=closed_te),
                                  ref_naca4(*section, closed_te=closed_te))


@pytest.mark.parametrize("alpha", [-7.5, 0.0, 12.0])
@pytest.mark.parametrize("grid", [(384, 192), (250, 130)])
def test_mask_equals_reference(alpha, grid):
    nx, ny = grid
    coords = ref_naca4(2, 4, 12, 60)
    cfg = config.LBMConfig(nx=nx, ny=ny)
    got = masks.rasterize_airfoil(coords, alpha, cfg)
    want = ref_masks.rasterize_airfoil(coords, alpha,
                                       ref_config.LBMConfig(nx=nx, ny=ny))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < nx * ny


def test_xfoil_truth_is_a_copy():
    """The parity harness's anchor table is a byte copy of the
    reference's, and loads to the same anchors."""
    from airfoil_tpu.bench import parity as ref_parity
    from airfoil_tpu_torch.bench import parity

    with open(parity._DATA, "rb") as a, open(ref_parity._DATA, "rb") as b:
        assert a.read() == b.read()
    assert parity.load_truth() == ref_parity.load_truth()
    assert os.path.dirname(os.path.dirname(parity._DATA)) == \
        os.path.join(ROOT, "airfoil_tpu_torch", "bench")


def test_static_page_is_a_copy():
    ref = os.path.join(ROOT, "airfoil_tpu", "ui", "static_app.html")
    with open(minihttp._STATIC_APP, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(os.path.dirname(minihttp._STATIC_APP)) == \
        os.path.join(ROOT, "airfoil_tpu_torch")


@pytest.mark.parametrize("name", ["_pg_conn", "_sqlite_conn", "init_db",
                                  "increment_analysis_count",
                                  "get_analysis_count"])
def test_stats_is_a_copy(name):
    """The analysis counter is the reference's, function for function, with
    the same environment variables and default file."""
    assert inspect.getsource(getattr(stats, name)) == \
        inspect.getsource(getattr(ref_stats, name))


def test_stats_path():
    env = dict(os.environ, AIRFOIL_TPU_STATS_PATH="/nowhere/s.db")
    code = ("import json\nfrom airfoil_tpu.utils import stats as r\n"
            "from airfoil_tpu_torch.utils import stats as p\n"
            "print(json.dumps([p._SQLITE_PATH, r._SQLITE_PATH]))")
    port_path, ref_path = _run(code, env)
    assert port_path == ref_path == "/nowhere/s.db"


@pytest.mark.parametrize("name", ["BENCH_REYNOLDS", "BENCH_ALPHA",
                                  "N_PANELS", "CHUNK"])
def test_parser_benchmark_constant(name):
    from airfoil_tpu.bench import parser_benchmark as ref_pb
    from airfoil_tpu_torch.bench import parser_benchmark as pb

    assert getattr(pb, name) == getattr(ref_pb, name)
    assert type(getattr(pb, name)) is type(getattr(ref_pb, name))


def test_corpus_is_a_copy(tmp_path):
    """The benchmark's corpus (500 files, seed 0) byte for byte, and what
    the no-repair reader takes from each file."""
    from airfoil_tpu.bench.corpus import generate_corpus as ref_generate
    from airfoil_tpu.bench.parser_benchmark import \
        raw_coords_from_file as ref_raw
    from airfoil_tpu_torch.bench.corpus import generate_corpus
    from airfoil_tpu_torch.bench.parser_benchmark import raw_coords_from_file

    got = generate_corpus(str(tmp_path / "port"), n=500, seed=0)
    want = ref_generate(str(tmp_path / "ref"), n=500, seed=0)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
        assert raw_coords_from_file(a) == ref_raw(b)


def test_corpus_kind_is_a_copy(tmp_path):
    from airfoil_tpu.bench.uiuc import corpus_kind as ref_kind
    from airfoil_tpu_torch.bench.uiuc import _MARKER, corpus_kind

    assert corpus_kind(str(tmp_path)) == ref_kind(str(tmp_path)) \
        == "synthetic"
    (tmp_path / _MARKER).write_text("fetched\n")
    assert corpus_kind(str(tmp_path)) == ref_kind(str(tmp_path)) \
        == "uiuc_real"


@pytest.mark.parametrize("fmt", FORMATS)
def test_classifiers_are_copies(fmt):
    """``classify_failure`` (on the no-repair coordinates) and
    ``classify_repairs`` of every corpus file of one format."""
    from airfoil_tpu.bench.classify_failures import \
        classify_failure as ref_failure
    from airfoil_tpu.bench.classify_repairs import \
        classify_repairs as ref_repairs
    from airfoil_tpu_torch.bench.classify_failures import classify_failure
    from airfoil_tpu_torch.bench.classify_repairs import classify_repairs
    from airfoil_tpu_torch.bench.parser_benchmark import raw_coords_from_file

    for path in _files_of(fmt):
        coords = raw_coords_from_file(path)
        name = os.path.basename(path)
        assert classify_failure(coords) == ref_failure(coords), name
        assert classify_repairs(path) == ref_repairs(path), name
