"""Generate (once) bench.py's xxlscale dataset (~30 GB raw) under .data/.

Host-only (JAX stays on the CPU). Safe to re-run; a completed dataset is
left alone.

Usage: python scripts/gen_xxlscale.py [target_mb]
"""

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bloomsearch_tpu import perf  # noqa: E402

TARGET_MB = int(sys.argv[1]) if len(sys.argv) > 1 else 30720


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main() -> None:
    perf.cached_dataset("xxlscale", TARGET_MB, seed=2, log=log)


if __name__ == "__main__":
    main()
