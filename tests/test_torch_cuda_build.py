"""``cuda_build`` on the CPU (no nvcc runs).

- The rebuild rule: a built library is reused only if it is newer than its
  sources and every ``csrc/*.cuh`` header, and was built with the same
  nvcc flags (its ``lib<name>.flags`` stamp).
- The table: ``LIBRARIES`` is what ``load_library`` builds, each library
  from its ``csrc/`` sources with ``NVCC_FLAGS`` and its own flags; no
  library takes a ``-D`` flag, and the tiled kernel's source has no knob.
- The launch path, against a stand-in library and a stand-in card
  (``torch.cuda.current_device`` 3, the current stream's handle 77):
  ``torch.device("cuda")`` launches on the current device and ``cuda:k``
  on ``k``, through the march wrapper too; the stream follows the
  arguments; a launch is counted in its wrapper's module, and a non-zero
  return raises with the library's text and counts nothing.
- The import direction: ``cuda_build`` and ``utils.compile_cache`` load
  none of ``api``, ``lbm`` and ``viscous``, and ``viscous/graphs.py``
  imports nothing of ``viscous``.
"""

import ast
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from airfoil_tpu_torch import cuda_build
from airfoil_tpu_torch.lbm import kernel as lbm_kernel
from airfoil_tpu_torch.viscous import kernel as march_kernel

FLAGS = " ".join([*cuda_build.NVCC_FLAGS, "-fmad=false"])


@pytest.fixture
def built(tmp_path):
    """A source and a library newer than it and than every header."""
    src = tmp_path / "k.cu"
    src.write_text("")
    lib = tmp_path / "libk.so"
    lib.write_text("")
    later = time.time() + 3600
    os.utime(lib, (later, later))
    return str(lib), [str(src)]


def _stamp(lib: str, flags: str) -> None:
    with open(f"{lib[:-3]}.flags", "w") as fh:
        fh.write(flags)


def test_fresh_with_the_same_flags(built):
    lib, sources = built
    _stamp(lib, FLAGS)
    assert cuda_build._is_fresh(lib, sources, FLAGS)


def test_stale_when_the_flags_change(built):
    lib, sources = built
    _stamp(lib, FLAGS)
    assert not cuda_build._is_fresh(lib, sources,
                                    " ".join(cuda_build.NVCC_FLAGS))


def test_stale_without_a_flags_stamp(built):
    lib, sources = built
    assert not cuda_build._is_fresh(lib, sources, FLAGS)


def test_stale_when_a_source_is_newer(built):
    lib, sources = built
    _stamp(lib, FLAGS)
    later = os.path.getmtime(lib) + 10
    os.utime(sources[0], (later, later))
    assert not cuda_build._is_fresh(lib, sources, FLAGS)


# ── the table ────────────────────────────────────────────────────────────

def test_load_library_builds_from_the_table(monkeypatch):
    built = {}

    def build(name, compiler, flags, sources):
        built[name] = (flags, sources)
        return name

    monkeypatch.setattr(cuda_build, "build_library", build)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    for name in cuda_build.LIBRARIES:
        assert cuda_build.load_library(name) == name
    assert set(built) == {"lbm_steps", "lbm_steps_tiled", "bl_march",
                          "field_b64"}
    for name, (sources, extra) in cuda_build.LIBRARIES.items():
        flags, paths = built[name]
        assert flags == [*cuda_build.NVCC_FLAGS, *extra]
        assert paths == [os.path.join(cuda_build.CSRC_DIR, s)
                         for s in sources]
        assert all(os.path.exists(p) for p in paths)
        assert not [f for f in flags if f.startswith("-D")]
    assert built["bl_march"][0][-1] == "-fmad=false"
    assert built["lbm_steps_tiled"][0] == cuda_build.NVCC_FLAGS
    with open(built["lbm_steps_tiled"][1][0]) as fh:
        assert "#ifndef" not in fh.read()


def test_bind_declares_the_signatures():
    lib = SimpleNamespace(**{fn: SimpleNamespace() for fn in ("go", "err")})
    assert cuda_build.bind(lib, "err", {"go": [cuda_build.ctypes.c_int]}) \
        is lib
    assert (lib.go.argtypes, lib.go.restype) == (
        [cuda_build.ctypes.c_int], cuda_build.ctypes.c_int)
    assert lib.error_string is lib.err
    assert lib.err.restype is cuda_build.ctypes.c_char_p


# ── the launch path ──────────────────────────────────────────────────────

class _Lib:
    """A bound library's stand-in: each C function records its arguments
    and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, fn):
        def c_fn(*args):
            self.calls.append((fn, args))
            return self.err
        return c_fn

    @staticmethod
    def error_string(err):
        return b"stand-in error %d" % err


@pytest.fixture
def card(monkeypatch):
    """A stand-in card: current device 3, the current stream's handle 77
    (and the stream asked for recorded)."""
    streams = []

    def current_stream(device=None):
        streams.append(device)
        return SimpleNamespace(cuda_stream=77)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return streams


DEVICES = [(torch.device("cuda"), 3), (torch.device("cuda", 2), 2),
           ("cuda:0", 0)]


@pytest.mark.parametrize("device,index", DEVICES, ids=["cuda", "cuda:2",
                                                       "str cuda:0"])
def test_launch_passes_the_device_index_and_stream(monkeypatch, card,
                                                   device, index):
    monkeypatch.setattr(lbm_kernel, "word_launches", 0)
    lib = _Lib()
    cuda_build.launch(lib, "k_launch", [5, 6], device,
                      (lbm_kernel.__name__, "word_launches"))
    assert lib.calls == [("k_launch", (5, 6, index, 77))]
    assert card == [device]
    assert cuda_build.device_index(device) == index
    assert lbm_kernel.word_launches == 1


def test_a_failed_launch_raises_and_is_not_counted(monkeypatch, card):
    monkeypatch.setattr(lbm_kernel, "launches", 0)
    with pytest.raises(RuntimeError, match="k_launch failed: stand-in "
                                           "error 4"):
        cuda_build.launch(_Lib(err=4), "k_launch", [], "cuda",
                          (lbm_kernel.__name__, "launches"))
    assert lbm_kernel.launches == 0


def test_the_kernels_run_on_cuda_only():
    with pytest.raises(ValueError, match="run on cuda, not cpu"):
        cuda_build.device_index(torch.device("cpu"))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``card`` as its device: the march wrapper
    reads only its device, shape, dtype and address."""

    card = torch.device("cuda")

    @property
    def device(self):
        return self.card


@pytest.mark.parametrize("device,index", DEVICES[:2], ids=["cuda",
                                                           "cuda:2"])
def test_the_march_launches_on_the_device_index(monkeypatch, card, device,
                                                index):
    """``viscous.kernel``'s march and wake launch on the tensors' device
    index: the current device's for ``cuda``, not card 0."""
    for fn in ("empty", "full"):     # the outputs stay on the CPU
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, device=None, _f=real,
                            **k: _f(*a, **k))
    monkeypatch.setattr(_OnCard, "card", device)
    monkeypatch.setattr(march_kernel, "march_launches", 0)
    monkeypatch.setattr(march_kernel, "wake_launches", 0)
    lib = _Lib()
    monkeypatch.setattr(march_kernel, "load", lambda: lib)
    s = torch.linspace(0.01, 1.0, 8).reshape(2, 4).as_subclass(_OnCard)
    march_kernel.march_side(s, s, s, 1e-6)
    march_kernel.march_wake(s, s, 1e-6, 1e-3, 2e-3, 0.03)
    assert [(fn, args[-4:]) for fn, args in lib.calls] == [
        ("bl_march_side_launch", (2, 4, index, 77)),
        ("bl_march_wake_launch", (2, 4, index, 77))]
    assert (march_kernel.march_launches, march_kernel.wake_launches) == \
        (1, 1)


# ── the import direction ─────────────────────────────────────────────────

def test_the_build_layer_imports_no_layer_above_it():
    code = ("import sys\n"
            "import airfoil_tpu_torch.cuda_build\n"
            "import airfoil_tpu_torch.utils.compile_cache\n"
            "print(' '.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__)))).stdout.split()
    assert "airfoil_tpu_torch.utils.compile_cache" in out
    above = [m for m in out for layer in ("api", "lbm", "viscous")
             if m.startswith(f"airfoil_tpu_torch.{layer}")]
    assert above == []


def test_the_graph_layer_imports_nothing_of_viscous():
    path = os.path.join(os.path.dirname(cuda_build.__file__), "viscous",
                        "graphs.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    imported = [a.name if isinstance(node, ast.Import)
                else f"{node.module}.{a.name}"
                for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for a in node.names]
    assert "airfoil_tpu_torch.cuda_build" in imported
    assert not [m for m in imported if "viscous" in m]
