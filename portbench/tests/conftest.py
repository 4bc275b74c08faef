"""CPU tests of the benchmark harness (``python -m pytest portbench/tests``
from the checkout's root). A test that needs a CUDA card is marked
``card`` and skips inside itself where there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without")
