"""Test configuration.

Runs JAX on a virtual 8-device CPU platform so multi-device sharding paths
are exercised without an accelerator. Tests that need a GPU carry the
``gpu`` marker and skip here through the ``gpu`` fixture; on a machine with
a card, ``python -m pytest -m gpu tests/`` leaves JAX's platform alone and
runs them there (chip_smoke.py covers the same paths at full size).
"""

import os
import sys

import pytest

# Repo root on sys.path so `import bloomsearch_tpu` works without install.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips (through the gpu fixture) without one"
    )
    if (config.getoption("markexpr", "") or "").strip() == "gpu":
        return  # GPU run: keep JAX's default platform
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()


@pytest.fixture
def gpu():
    """Skip unless JAX's default platform is a GPU; -> the first device."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with -m gpu on a machine with a card)")
    return jax.devices()[0]
