"""Restart sidecar cache (servingcache.py): roundtrip parity, validation,
invalidation, and the engine restart fast path."""

import os

import numpy as np
import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu.file_format import DataBlockMetadata
from bloomsearch_tpu.rowcache import pack_block
from bloomsearch_tpu.servingcache import PACK_VERSION, ServingStateCache


def _rows_blob(n=200, seed=0):
    rng = np.random.default_rng(seed)
    parts, offsets, lengths = [], [], []
    pos = 0
    for i in range(n):
        row = b'{"msg":"Payload %d %s"}' % (
            i,
            bytes(rng.integers(97, 123, size=int(rng.integers(5, 40)))),
        )
        offsets.append(pos)
        lengths.append(len(row))
        parts.append(row)
        pos += len(row)
    return (
        b"".join(parts),
        np.asarray(offsets, dtype=np.int64),
        np.asarray(lengths, dtype=np.int64),
    )


def _blk(data, offsets, *, offset=0, compression="none", hash_=12345):
    return DataBlockMetadata(
        offset=offset,
        size=len(data),
        rows=offsets.shape[0],
        compression=compression,
        uncompressed_size=len(data),
        row_data_hash=hash_,
    )


class TestRoundtrip:
    def test_store_load_bit_parity(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(300)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets, compression="snappy")
        comp_index = np.arange(7, dtype=np.int64) * 131
        assert sc.store(
            b"ptr-a", blk, chunks, flags, n_chunks, offsets, lengths, comp_index
        )
        hit = sc.load(b"ptr-a", blk)
        assert hit is not None
        assert hit.n_chunks == n_chunks
        np.testing.assert_array_equal(np.asarray(hit.chunks), chunks)
        np.testing.assert_array_equal(hit.always_candidate, flags)
        np.testing.assert_array_equal(hit.row_offsets, offsets.astype(np.int32))
        np.testing.assert_array_equal(hit.row_lengths, lengths.astype(np.int32))
        np.testing.assert_array_equal(hit.comp_index, comp_index)
        assert sc.stats() == {"hits": 1, "misses": 0, "stores": 1}

    def test_store_skips_existing(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(50)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets)
        assert sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        assert not sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)

    def test_no_comp_index(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(50)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets)
        sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        hit = sc.load(b"p", blk)
        assert hit is not None and hit.comp_index is None

    def test_non_ascii_flags_roundtrip(self, tmp_path):
        rows = [b'{"m":"plain ascii"}', '{"m":"K unicode"}'.encode()]
        offsets = np.asarray([0, len(rows[0])], dtype=np.int64)
        lengths = np.asarray([len(rows[0]), len(rows[1])], dtype=np.int64)
        data = b"".join(rows)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        assert flags.tolist() == [False, True]
        sc = ServingStateCache(str(tmp_path))
        blk = _blk(data, offsets)
        sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        hit = sc.load(b"p", blk)
        np.testing.assert_array_equal(hit.always_candidate, flags)


class TestValidation:
    def _stored(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(80)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets)
        sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        return sc, blk, data, offsets

    def test_hash_mismatch_misses(self, tmp_path):
        sc, blk, data, offsets = self._stored(tmp_path)
        other = _blk(data, offsets, hash_=blk.row_data_hash + 1)
        assert sc.load(b"p", other) is None  # different name -> not found

    def test_truncation_misses(self, tmp_path):
        sc, blk, _, _ = self._stored(tmp_path)
        (path,) = [
            os.path.join(str(tmp_path), n)
            for n in os.listdir(str(tmp_path))
            if n.endswith(".srv")
        ]
        blob = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(blob[:-20])
        assert sc.load(b"p", blk) is None

    def test_version_skew_misses(self, tmp_path, monkeypatch):
        sc, blk, _, _ = self._stored(tmp_path)
        monkeypatch.setattr(
            "bloomsearch_tpu.servingcache.PACK_VERSION", PACK_VERSION + 1
        )
        assert sc.load(b"p", blk) is None

    def test_garbage_file_misses(self, tmp_path):
        sc, blk, _, _ = self._stored(tmp_path)
        (path,) = [
            os.path.join(str(tmp_path), n)
            for n in os.listdir(str(tmp_path))
            if n.endswith(".srv")
        ]
        with open(path, "wb") as fh:
            fh.write(b"not a sidecar at all")
        assert sc.load(b"p", blk) is None

    def test_invalidate_file(self, tmp_path):
        sc, blk, data, offsets = self._stored(tmp_path)
        assert sc.load(b"p", blk) is not None
        sc.invalidate_file(b"p")
        assert sc.load(b"p", blk) is None
        assert not any(n.endswith(".srv") for n in os.listdir(str(tmp_path)))


class TestEngineRestart:
    def _config(self, cache_dir):
        return bs.BloomSearchEngineConfig(
            row_data_compression="snappy",
            probe_backend="device",
            row_cache_bytes=256 << 20,
            serving_cache_dir=str(cache_dir),
            row_cache_async_pins=False,
        )

    def _needle_results(self, engine):
        res = engine.query_sync(bs.new_query().token("needle").build(), timeout=60)
        return sorted(r["n"] for r in res)

    def test_restart_hits_sidecar_and_matches(self, tmp_path):
        from bloomsearch_tpu.compression import compression_available

        if not compression_available("snappy"):
            pytest.skip("snappy unavailable")
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        cache_dir = tmp_path / "sidecars"

        engine = bs.BloomSearchEngine(self._config(cache_dir), store, store)
        engine.start()
        try:
            rows = [{"n": i, "msg": f"log line {i} zzz"} for i in range(3000)]
            rows.append({"n": -1, "msg": "special needle row"})
            engine.ingest_rows(rows, timeout=30)
            engine.flush(timeout=30)
            engine.warmup(block=True, timeout=120)
            first = self._needle_results(engine)
            assert first == [-1]
            stats1 = engine.stats()["serving_cache"]
            assert stats1["stores"] >= 1 and stats1["hits"] == 0
        finally:
            engine.stop(timeout=30)

        engine2 = bs.BloomSearchEngine(self._config(cache_dir), store, store)
        engine2.start()
        try:
            engine2.warmup(block=True, timeout=120)
            stats2 = engine2.stats()["serving_cache"]
            # Every warmup pin must come from the sidecar on restart.
            assert stats2["hits"] >= 1 and stats2["stores"] == 0
            assert stats2["misses"] == 0
            assert self._needle_results(engine2) == [-1]
            res = engine2.query_sync(
                bs.new_query().token("zzz").build(), timeout=60
            )
            assert len(res) == 3000
        finally:
            engine2.stop(timeout=30)

    def test_merge_tombstone_invalidates_sidecars(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        cache_dir = tmp_path / "sidecars"
        config = self._config(cache_dir)
        engine = bs.BloomSearchEngine(config, store, store)
        engine.start()
        try:
            for i in range(3):
                engine.ingest_rows(
                    [{"n": i * 10 + j, "msg": f"tok{i}"} for j in range(50)],
                    timeout=30,
                )
                engine.flush(timeout=30)
            engine.warmup(block=True, timeout=120)
            n_before = len(
                [n for n in os.listdir(str(cache_dir)) if n.endswith(".srv")]
            )
            assert n_before >= 3
            engine.merge()
            names = [n for n in os.listdir(str(cache_dir)) if n.endswith(".srv")]
            # Old files' sidecars removed with their tombstones.
            assert len(names) < n_before
            res = engine.query_sync(bs.new_query().token("tok1").build(), timeout=60)
            assert len(res) == 50
        finally:
            engine.stop(timeout=30)
