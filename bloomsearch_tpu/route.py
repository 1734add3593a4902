"""Which device path runs on this platform — the one place that decides.

Every caller that chooses between the host and the device, or between scan
implementations, asks here:

- :func:`use_device` — the engine's probe route. ``"device"`` always runs
  the JAX path (on a CPU-only host that is XLA:CPU, which the tests use);
  ``"host"`` never does; ``"auto"`` runs the device path on a GPU and keeps
  the host path on a CPU-only host, where numpy probing beats XLA:CPU.
- :func:`scan_impl` — the stream scan: the Pallas kernel compiled through
  Triton on a GPU, the plain-jnp SWAR scan elsewhere.
- :func:`enable_compile_cache` — where compiled programs persist.

The bank probe has one implementation everywhere (XLA's fusion of
bloom/device_probe.py), so it needs no choice here.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

# Platforms (jax.default_backend()) with a compiled device path.
ACCELERATORS = ("gpu",)

# Fixed in-checkout compile cache (listed in .gitignore). The path is part
# of the cache key, so it must not move between runs.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def platform() -> str:
    import jax

    return jax.default_backend()


def is_accelerator(plat: str) -> bool:
    return plat in ACCELERATORS


def use_device(probe_backend: str, plat: Optional[str] = None) -> bool:
    """Whether an engine configured with ``probe_backend`` builds the
    device backend on ``plat`` (default: this process's JAX platform, read
    only for "auto" so host-only engines never initialize JAX)."""
    if probe_backend == "host":
        return False
    if probe_backend == "device":
        return True
    if probe_backend == "auto":
        return is_accelerator(platform() if plat is None else plat)
    raise ValueError(f"probe_backend must be auto|device|host, got {probe_backend!r}")


def scan_impl(plat: str) -> str:
    """``"triton"`` (stream_scan.scan_triton) or ``"xla"`` (scan_xla)."""
    return "triton" if plat == "gpu" else "xla"


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The directory this program sets for JAX's persistent compile cache:
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself),
    otherwise the fixed in-checkout :data:`CACHE_DIR`."""
    env = os.environ if environ is None else environ
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def enable_compile_cache() -> str:
    """Persist compiled programs across processes; -> the cache directory.

    Call before the first compile. A restarted engine (or the next process
    of a benchmark) then reads its probe and scan programs back instead of
    recompiling them."""
    import jax

    d = compile_cache_dir()
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)
    # Warmup compiles dozens of programs, many under the 1 s default.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return d if d is not None else os.environ["JAX_COMPILATION_CACHE_DIR"]
