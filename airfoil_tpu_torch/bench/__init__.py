"""Benchmarks of the port: the parity harness against XFOIL anchors
(``bench.parity``)."""
