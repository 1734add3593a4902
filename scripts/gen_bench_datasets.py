"""Pre-generate bench.py's datasets (refscale 1.6 GB, xlscale 8 GB).

Builds them under the checkout's .data/ with bench.py's names and seeds, so
a later bench run reuses them instead of paying generation time. Host-only
(JAX stays on the CPU). Safe to re-run: completed datasets are left alone.

Usage: python scripts/gen_bench_datasets.py
"""

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bloomsearch_tpu import perf  # noqa: E402


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main() -> None:
    perf.cached_dataset("refscale", 1600, seed=0, log=log)
    perf.cached_dataset("xlscale", 8192, seed=1, log=log)


if __name__ == "__main__":
    main()
