"""``cuda_build``'s rebuild rule, on the CPU (no nvcc runs): a built library
is reused only if it is newer than its sources and every ``csrc/*.cuh``
header, and was built with the same nvcc flags (its ``lib<name>.flags``
stamp)."""

import os
import time

import pytest

from airfoil_tpu_torch import cuda_build

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
