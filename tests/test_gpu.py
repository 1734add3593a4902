"""Paths that exist only on a GPU: the compiled Triton scan and the engine's
"auto" device route. They skip without a card; chip_smoke.py runs the same
paths at full size."""

import numpy as np
import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu.rowcache import CHUNK_BYTES, MAX_NEEDLE, STREAM_STRIDE

pytestmark = pytest.mark.gpu


def test_compiled_triton_scan_matches_xla_scan(gpu):
    import jax.numpy as jnp

    from bloomsearch_tpu.stream_scan import scan_triton, scan_word_bucket, scan_xla

    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, size=(4096, CHUNK_BYTES), dtype=np.uint8)
    needles = [bytes(rng.integers(0, 256, size=n, dtype=np.uint8)) for n in (1, 5, 13, 32)]
    for i, nd in enumerate(needles):
        rows[7 * i + 1, 100 + i : 100 + i + len(nd)] = np.frombuffer(nd, np.uint8)
    padded = np.zeros((8, MAX_NEEDLE), np.int32)
    lens = np.zeros(8, np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    args = (jnp.asarray(rows.view(np.int32)), jnp.asarray(padded), jnp.asarray(lens))
    kw = dict(n_real=len(needles), max_words=scan_word_bucket(32),
              valid_words=STREAM_STRIDE // 4)
    np.testing.assert_array_equal(np.asarray(scan_triton(*args, **kw)),
                                  np.asarray(scan_xla(*args, **kw)))


def test_auto_engine_runs_device_path(gpu, tmp_path):
    store = bs.FileSystemDataStore(str(tmp_path))
    config = bs.BloomSearchEngineConfig(
        row_data_compression="none", row_cache_bytes=64 << 20,
        row_cache_async_pins=False, mesh_devices=1,
    )
    engine = bs.BloomSearchEngine(config, store, store)
    engine.start()
    try:
        assert engine._device_backend is not None
        assert engine._row_cache.scan_impl == "triton"
        rows = [{"n": i, "msg": f"w{i} common"} for i in range(50)]
        engine.ingest_rows(rows, timeout=30)
        engine.flush(timeout=30)
        q = bs.new_query().token("w7").build()
        for _ in range(2):  # second pass scans the pinned stream
            assert engine.query_sync(q, timeout=30) == [rows[7]]
        assert engine._device_backend.launches > 0
        assert engine._row_cache.launches > 0
    finally:
        engine.stop(timeout=30)
