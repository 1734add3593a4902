"""route.py: the one module that decides which device path runs where."""

import os

import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu import route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestUseDevice:
    @pytest.mark.parametrize(
        "probe_backend,plat,want",
        [
            ("auto", "cpu", False),
            ("auto", "gpu", True),
            ("device", "cpu", True),
            ("device", "gpu", True),
            ("host", "cpu", False),
            ("host", "gpu", False),
        ],
    )
    def test_route_table(self, probe_backend, plat, want):
        assert route.use_device(probe_backend, plat) is want

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError):
            route.use_device("cuda", "gpu")

    @pytest.mark.parametrize("plat,want", [("gpu", "triton"), ("cpu", "xla")])
    def test_scan_impl(self, plat, want):
        assert route.scan_impl(plat) == want

    def test_auto_on_cpu_keeps_host_path(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path))
        config = bs.BloomSearchEngineConfig(
            row_data_compression="none", row_cache_bytes=64 << 20
        )
        engine = bs.BloomSearchEngine(config, store, store)
        assert engine._device_backend is None
        assert engine._row_cache is None

    def test_auto_raises_when_gpu_backend_fails(self, tmp_path, monkeypatch):
        """A visible GPU whose device backend cannot be built is an error,
        not a silent host fallback."""
        from bloomsearch_tpu.bloom import bank

        def broken(self, *a, **k):
            raise RuntimeError("device backend init failed")

        monkeypatch.setattr(route, "platform", lambda: "gpu")
        monkeypatch.setattr(bank.DeviceProbeBackend, "__init__", broken)
        store = bs.FileSystemDataStore(str(tmp_path))
        config = bs.BloomSearchEngineConfig(row_data_compression="none")
        with pytest.raises(RuntimeError, match="device backend init failed"):
            bs.BloomSearchEngine(config, store, store)

    def test_row_cache_takes_scan_impl_from_route(self, monkeypatch):
        from bloomsearch_tpu.rowcache import DeviceRowCache

        monkeypatch.setattr(route, "platform", lambda: "gpu")
        assert DeviceRowCache(1 << 20, mesh_devices=1).scan_impl == "triton"
        monkeypatch.setattr(route, "platform", lambda: "cpu")
        assert DeviceRowCache(1 << 20, mesh_devices=1).scan_impl == "xla"


class TestCompileCache:
    def test_env_var_wins(self):
        assert route.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None

    def test_fixed_path_inside_checkout_and_ignored(self):
        d = route.compile_cache_dir({})
        assert d == route.CACHE_DIR
        assert os.path.dirname(d) == REPO
        with open(os.path.join(REPO, ".gitignore")) as fh:
            ignored = {line.strip().rstrip("/") for line in fh}
        assert os.path.basename(d) in ignored

    @pytest.mark.parametrize("env_dir", [None, "/tmp/jax-cache-from-env"])
    def test_enable_sets_only_the_fixed_dir(self, monkeypatch, env_dir):
        import jax

        updates = {}
        monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        got = route.enable_compile_cache()
        if env_dir is None:
            assert got == route.CACHE_DIR
            assert updates["jax_compilation_cache_dir"] == route.CACHE_DIR
        else:
            assert got == env_dir
            assert "jax_compilation_cache_dir" not in updates

    def test_device_backend_enables_cache_on_accelerator_only(self, monkeypatch):
        from bloomsearch_tpu.bloom.bank import DeviceProbeBackend

        calls = []
        monkeypatch.setattr(route, "enable_compile_cache", lambda: calls.append(1))
        monkeypatch.setattr(route, "platform", lambda: "cpu")
        DeviceProbeBackend(mesh_devices=1)
        assert calls == []
        monkeypatch.setattr(route, "platform", lambda: "gpu")
        DeviceProbeBackend(mesh_devices=1)
        assert calls == [1]
