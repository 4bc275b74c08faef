"""Benchmarks and diagnostics of the port: the headline benchmark
(``bench.headline``), the parser-robustness benchmark over an airfoil
corpus (``bench.parser_benchmark``, its corpus and the failure/repair
classifiers), the paneling probe and the parity harness against XFOIL
(``bench.parity``)."""

from airfoil_tpu_torch.bench.corpus import generate_corpus
from airfoil_tpu_torch.bench.parser_benchmark import run_benchmark
from airfoil_tpu_torch.bench.classify_failures import classify_failure
from airfoil_tpu_torch.bench.classify_repairs import classify_repairs

__all__ = [
    "generate_corpus",
    "run_benchmark",
    "classify_failure",
    "classify_repairs",
]
