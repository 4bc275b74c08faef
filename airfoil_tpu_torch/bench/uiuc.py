"""UIUC airfoil-database fetcher for the parser/robustness benchmark.

(A copy of ``airfoil_tpu/bench/uiuc.py``, kept so that the port imports
nothing of the JAX package.)

The reference validates its parser against the full UIUC coordinate
database (~1,550 .dat files) fetched per run (reference
benchmark/airfoil_parser_benchmark.py:171-288: zip or per-file source,
rate-limited, resumable). This module provides the same capability for
``parser_benchmark.py --data-dir``:

    python -m airfoil_tpu_torch.bench.uiuc --dest uiuc_dats [--limit N]
    python -m airfoil_tpu_torch.bench.parser_benchmark --data-dir uiuc_dats

Without network access the benchmark's results come from the synthetic
hard-geometry corpus
(``corpus.py`` — real UIUC point densities + digitisation noise +
Lednicer/Selig formatting variation) and the summary labels its corpus
accordingly. Run this fetcher wherever egress exists to reproduce the
benchmark on the real database; a ``UIUC_SOURCE`` marker file is written
so the benchmark summary reports ``corpus: uiuc_real``.
"""

from __future__ import annotations

import argparse
import io
import os
import time
import urllib.request
import zipfile

__all__ = ["download_uiuc", "corpus_kind"]

_BASE = "https://m-selig.ae.illinois.edu/ads"
_ZIP_URL = f"{_BASE}/archives/coord_seligFmt.zip"
_COORD_URL = f"{_BASE}/coord"
_MARKER = "UIUC_SOURCE"


def corpus_kind(data_dir: str) -> str:
    """'uiuc_real' when the directory was produced by this fetcher,
    'synthetic' otherwise — surfaced in the benchmark summary so the
    headline robustness number is never mistaken for a real-UIUC run."""
    return ("uiuc_real"
            if os.path.exists(os.path.join(data_dir, _MARKER))
            else "synthetic")


def _fetch(url: str, timeout: float = 60.0) -> bytes:
    req = urllib.request.Request(url, headers={
        "User-Agent": "airfoil-tpu-benchmark/1.0"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def download_uiuc(dest: str, limit: int | None = None,
                  rate_limit_s: float = 0.5, source: str = "zip") -> int:
    """Populate ``dest`` with UIUC .dat files. Resumable: files already
    present are skipped. Returns the number of files on disk."""
    os.makedirs(dest, exist_ok=True)

    if source == "zip":
        try:
            blob = _fetch(_ZIP_URL, timeout=300.0)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                names = [n for n in zf.namelist()
                         if n.lower().endswith(".dat")]
                names.sort()
                if limit:
                    names = names[:limit]
                for n in names:
                    out = os.path.join(dest, os.path.basename(n))
                    if not os.path.exists(out):
                        with open(out, "wb") as f:
                            f.write(zf.read(n))
            _mark(dest)
            return _count(dest)
        except Exception as e:
            print(f"zip source failed ({e}); falling back to per-file")
            source = "coord"

    # Per-file source: fetch the directory index, then each .dat,
    # rate-limited and resumable (mirrors the reference's courtesy
    # behaviour toward the UIUC server).
    index = _fetch(f"{_COORD_URL}/").decode("utf-8", errors="ignore")
    import re

    names = sorted(set(re.findall(r'href="([^"]+\.dat)"', index)))
    if limit:
        names = names[:limit]
    for i, n in enumerate(names):
        out = os.path.join(dest, os.path.basename(n))
        if os.path.exists(out):
            continue
        try:
            blob = _fetch(f"{_COORD_URL}/{n}")
            with open(out, "wb") as f:
                f.write(blob)
        except Exception as e:
            print(f"  {n}: {e} (continuing)")
        time.sleep(rate_limit_s)
        if (i + 1) % 50 == 0:
            print(f"  {i + 1}/{len(names)} fetched")
    _mark(dest)
    return _count(dest)


def _mark(dest: str):
    with open(os.path.join(dest, _MARKER), "w") as f:
        f.write(f"fetched from {_BASE} at "
                f"{time.strftime('%Y-%m-%d %H:%M:%S')}\n")


def _count(dest: str) -> int:
    return sum(1 for n in os.listdir(dest) if n.endswith(".dat"))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dest", default="uiuc_dats")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--source", choices=("zip", "coord"), default="zip")
    args = ap.parse_args()
    n = download_uiuc(args.dest, args.limit, source=args.source)
    print(f"{n} .dat files in {args.dest}")


if __name__ == "__main__":
    main()
