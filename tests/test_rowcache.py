"""Device row cache: on-device scan parity + engine serving-mode E2E.

The stream design is conservative at CHUNK granularity: a needle hit in a
512-byte stream chunk marks every row overlapping the possible match span
(the host scanner's span-overlap rule, widened to the chunk). Tests assert
ZERO FALSE NEGATIVES exactly, absent needles produce no candidates, and
present-needle over-marking matches the chunk-expansion oracle bit for bit.
"""

import json
import random

import numpy as np
import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu import native
from bloomsearch_tpu.file_format import encode_row
from bloomsearch_tpu.rowcache import (
    CHUNK_BYTES,
    MAX_NEEDLE,
    STREAM_STRIDE,
    DeviceRowCache,
    _pack_stream_numpy,
    _round_up,
)
from bloomsearch_tpu.scan import split_rows_arrays


def make_stream(rows):
    return b"".join(
        encode_row(json.dumps(r, separators=(",", ":")).encode()) for r in rows
    )


def chunk_oracle(data: bytes, offsets, lengths, needle: bytes) -> np.ndarray:
    """The exact expected device result: chunk hits on the lowered stream,
    expanded to rows overlapping [c*STRIDE, c*STRIDE + STRIDE + len - 1)."""
    low = bytes(
        c + 32 if ord("A") <= c <= ord("Z") else c for c in data
    )
    n = len(low)
    out = np.zeros(len(offsets), dtype=bool)
    n_chunks = -(-n // STREAM_STRIDE) if n else 0
    ends = offsets + lengths
    for c in range(n_chunks):
        lo_b, hi_b = c * STREAM_STRIDE, min((c + 1) * STREAM_STRIDE, n)
        pos = low.find(needle, lo_b)
        if pos < 0 or pos >= hi_b:
            continue
        span_end = lo_b + STREAM_STRIDE + len(needle) - 1
        out |= (offsets < span_end) & (ends > lo_b)
    return out


class TestDeviceRowCache:
    def test_scan_superset_of_host_and_matches_oracle(self):
        rng = random.Random(3)
        words = ["alpha", "BRAVO", "charlie9", "x y z", "needle-one"]
        rows = [
            {"m": " ".join(rng.choice(words) for _ in range(rng.randrange(1, 4)))}
            for _ in range(200)
        ]
        data = make_stream(rows)
        buf, offsets, lengths = split_rows_arrays(data)
        needles = [b"bravo", b"needle-one", b"absent-needle"]

        cache = DeviceRowCache(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        device_scan = cache.scan(pinned, needles)

        for qi, needle in enumerate(needles):
            truth = np.array(
                [
                    needle.decode() in json.dumps(r, separators=(",", ":")).lower()
                    for r in rows
                ]
            )
            # Zero false negatives, and exactly the chunk-expansion oracle.
            assert (device_scan[qi] | ~truth).all(), needle
            np.testing.assert_array_equal(
                device_scan[qi], chunk_oracle(data, offsets, lengths, needle),
                err_msg=repr(needle),
            )
        # Absent needle: no candidates at all.
        assert not device_scan[2].any()
        if native.available():
            host_scan = native.scan_candidates(buf, needles, offsets, lengths)
            assert (device_scan | ~host_scan).all(), "device missed a host hit"

    def test_match_at_row_tail(self):
        # Regression: matches in a row's final bytes (and anywhere in the
        # chunk payload region) must be found.
        rows = [{"a": "x" * 90 + " endneedle"}, {"b": "short"}]
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)
        cache = DeviceRowCache(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        scan = cache.scan(pinned, [b"endneedle"])
        assert scan[0, 0]

    def test_oversized_needle_conservative(self):
        rows = [{"a": "hello"}]
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)
        cache = DeviceRowCache(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        scan = cache.scan(pinned, [b"x" * 64])  # > MAX_NEEDLE
        assert scan[0, 0]  # conservative: candidate

    def test_long_rows_scan_exactly(self):
        # Rows longer than the old fixed-width cap are plain stream bytes
        # now — an absent needle proves absence even for a 5 KB row, and a
        # needle planted deep inside one is found.
        rows = [{"big": "x" * 5000 + " deepneedle " + "y" * 400}, {"small": "z"}]
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)
        cache = DeviceRowCache(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        scan = cache.scan(pinned, [b"zzz-not-present", b"deepneedle"])
        assert not scan[0].any()  # exact: absent nowhere, even in long rows
        assert scan[1, 0]

    def test_lru_eviction(self):
        rows = [{"k": "v" * 100} for _ in range(50)]
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)
        one = DeviceRowCache(0)  # capacity smaller than any block: keeps last
        one.pin((b"a", 0), data, offsets, lengths)
        one.pin((b"b", 0), data, offsets, lengths)
        assert one.get((b"a", 0)) is None
        assert one.get((b"b", 0)) is not None

    def test_invalidate_file(self):
        rows = [{"k": "v"}]
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)
        cache = DeviceRowCache(64 << 20)
        cache.pin((b"f", 0), data, offsets, lengths)
        cache.pin((b"f", 10), data, offsets, lengths)
        cache.pin((b"g", 0), data, offsets, lengths)
        cache.invalidate_file(b"f")
        assert cache.get((b"f", 0)) is None
        assert cache.get((b"f", 10)) is None
        assert cache.get((b"g", 0)) is not None


class TestNativePackParity:
    def test_native_pack_stream_matches_numpy_spec(self):
        """bs_pack_stream (C++ chunk+lowercase+flag single pass) must
        produce the exact chunk matrix and always-candidate flags of
        _pack_stream_numpy (the spec), including the adversarial cases:
        uppercase \\U escapes (pair's second byte compared lowered),
        non-ASCII bytes, \\/ and literal backslashes, empty rows, rows
        crossing chunk boundaries, and 8-byte SWAR boundary alignments."""
        if not native.available() or native.pack_stream(
            b"", np.empty(0, np.int64), np.empty(0, np.int64),
            STREAM_STRIDE, CHUNK_BYTES,
        ) is None:
            pytest.skip("native pack_stream unavailable")
        rng = random.Random(7)
        specials = ["\\u0041", "\\U0041", "\\/", "\\\\", "café", "A" * 7, "Z" * 9, ""]
        rows = []
        for i in range(300):
            parts = [
                "".join(rng.choice("abcXYZ  09_-") for _ in range(rng.randrange(0, 40)))
            ]
            if rng.random() < 0.5:
                parts.append(rng.choice(specials))
            if rng.random() < 0.02:
                parts.append("x" * 4200)
            rows.append({"k": "".join(parts)})
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)

        nat = native.pack_stream(
            data, offsets, lengths, STREAM_STRIDE, CHUNK_BYTES
        )
        assert nat is not None
        chunks_n, flags_n = nat
        chunks_p, flags_p = _pack_stream_numpy(data, offsets, lengths)
        np.testing.assert_array_equal(chunks_n, chunks_p)
        np.testing.assert_array_equal(flags_n.astype(bool), flags_p)
        # And through pin(): both paths land identical device matrices.
        cache_native = DeviceRowCache(256 << 20, mesh_devices=1)
        pin_native = cache_native.pin((b"n", 0), data, offsets, lengths)

        import bloomsearch_tpu.rowcache as rc_mod

        orig = rc_mod._native.pack_stream
        rc_mod._native.pack_stream = lambda *a, **k: None
        try:
            cache_numpy = DeviceRowCache(256 << 20, mesh_devices=1)
            pin_numpy = cache_numpy.pin((b"n", 0), data, offsets, lengths)
        finally:
            rc_mod._native.pack_stream = orig
        np.testing.assert_array_equal(
            pin_native.always_candidate, pin_numpy.always_candidate
        )
        np.testing.assert_array_equal(
            np.asarray(cache_native._bucket.matrix),
            np.asarray(cache_numpy._bucket.matrix),
        )


class TestEngineServingMode:
    def test_row_cache_query_parity(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        config = bs.BloomSearchEngineConfig(
            row_data_compression="none",
            probe_backend="device",  # row cache requires the device backend
            row_cache_bytes=256 << 20,
        )
        engine = bs.BloomSearchEngine(config, store, store)
        assert engine._row_cache is not None
        engine.start()
        try:
            rows = [{"n": i, "w": f"word{i}"} for i in range(300)]
            rows.append({"n": -1, "w": "special needle"})
            engine.ingest_rows(rows, timeout=10)
            engine.flush(timeout=10)

            # First query pins the block (asynchronously — pins yield to
            # in-flight queries, so drain before relying on residency);
            # second scans on-device.
            for _ in range(2):
                res = engine.query_sync(bs.new_query().token("needle").build(), timeout=60)
                assert len(res) == 1 and res[0]["n"] == -1
                engine.drain_background_pins(timeout=30)
            assert engine._row_cache.total_bytes() > 0

            res = engine.query_sync(bs.new_query().token("word42").build(), timeout=60)
            assert len(res) == 1 and res[0]["n"] == 42
        finally:
            engine.stop(timeout=10)


class TestShadowFreeServing:
    """row_cache_host_shadow: candidate rows re-read from the store instead
    of a decompressed host copy per pinned block."""

    def _run_engine(self, tmp_path, name, codec, shadow, n_rows=4000):
        store = bs.FileSystemDataStore(str(tmp_path / name))
        config = bs.BloomSearchEngineConfig(
            row_data_compression=codec,
            probe_backend="device",
            row_cache_bytes=256 << 20,
            row_cache_host_shadow=shadow,
        )
        engine = bs.BloomSearchEngine(config, store, store)
        engine.start()
        rows = [
            {"n": i, "w": f"word{i}", "msg": f"some log line payload {i} xyz"}
            for i in range(n_rows)
        ]
        rows.append({"n": -1, "w": "special needle", "msg": "find me"})
        engine.ingest_rows(rows, timeout=30)
        engine.flush(timeout=30)
        return engine

    @pytest.mark.parametrize("codec", ["none", "snappy", "zstd"])
    def test_parity_across_codecs(self, tmp_path, codec):
        from bloomsearch_tpu.compression import compression_available

        if not compression_available(codec):
            pytest.skip(f"{codec} unavailable")
        engine = self._run_engine(tmp_path, f"sf-{codec}", codec, shadow=False)
        try:
            for _ in range(2):  # cold pin, then warm shadow-free extraction
                engine.drain_background_pins(timeout=30)
                res = engine.query_sync(
                    bs.new_query().token("needle").build(), timeout=60
                )
                assert len(res) == 1 and res[0]["n"] == -1
            res = engine.query_sync(bs.new_query().token("word1234").build(), timeout=60)
            assert len(res) == 1 and res[0]["n"] == 1234
            # Wide result set exercises multi-run coalescing.
            res = engine.query_sync(bs.new_query().token("xyz").build(), timeout=60)
            assert len(res) == 4000
            stats = engine._row_cache.stats()
            # Shadow-free: host side holds only coordinate/flag arrays.
            assert stats["host_bytes"] < stats["device_bytes"] / 5
        finally:
            engine.stop(timeout=10)

    def test_auto_uses_shadow_free_on_filesystem(self, tmp_path):
        engine = self._run_engine(tmp_path, "auto", "none", shadow="auto", n_rows=50)
        try:
            engine.query_sync(bs.new_query().token("needle").build(), timeout=60)
            engine.drain_background_pins(timeout=30)
            key = next(iter(engine._row_cache._blocks))
            assert engine._row_cache._blocks[key].data is None
            assert engine._row_cache._blocks[key].fetcher is not None
        finally:
            engine.stop(timeout=10)

    def test_explicit_shadow_keeps_host_copy(self, tmp_path):
        engine = self._run_engine(tmp_path, "shadow", "none", shadow=True, n_rows=50)
        try:
            engine.query_sync(bs.new_query().token("needle").build(), timeout=60)
            engine.drain_background_pins(timeout=30)
            key = next(iter(engine._row_cache._blocks))
            assert engine._row_cache._blocks[key].data is not None
        finally:
            engine.stop(timeout=10)

    def test_fetch_rows_spot_check(self, tmp_path):
        """fetch_rows returns byte-identical rows to the decompressed block."""
        import json

        engine = self._run_engine(tmp_path, "spot", "snappy", shadow=False, n_rows=2000)
        try:
            engine.query_sync(bs.new_query().token("needle").build(), timeout=60)
            engine.drain_background_pins(timeout=30)
            key, blk = next(iter(engine._row_cache._blocks.items()))
            idx = np.array([0, 1, 7, 500, 1999], dtype=np.int64)
            buf, off, ln = blk.fetch_rows(idx)
            for j in range(len(idx)):
                row = json.loads(bytes(buf[off[j] : off[j] + ln[j]]))
                assert isinstance(row, dict)
            # Empty fetch.
            buf, off, ln = blk.fetch_rows(np.empty(0, dtype=np.int64))
            assert len(off) == 0
        finally:
            engine.stop(timeout=10)


class TestBackgroundForegroundContention:
    def test_foreground_pin_wait_breaks_background_yield(self):
        """Priority-inversion guard: a background holder of _upload_lock
        pausing at a yield point (queries in flight) must HURRY once a
        foreground pin blocks on the lock — sleeping 'for the query' while
        the query waits on us would stall it up to the full yield budget."""
        import threading
        import time as _time

        from bloomsearch_tpu.rowcache import _yield_point

        cache = DeviceRowCache(64 << 20)

        def bg_holder():
            with cache._mutation_lock(foreground=False):
                # A background pin mid-upload, yielding to "always busy"
                # queries with a 5 s budget.
                _yield_point(
                    lambda: True,
                    _time.monotonic() + 5.0,
                    cache._has_upload_waiters,
                )

        t = threading.Thread(target=bg_holder)
        t0 = _time.monotonic()
        t.start()
        _time.sleep(0.1)
        data = make_stream([{"m": "hello"}])
        _, offsets, lengths = split_rows_arrays(data)
        cache.pin((b"fg", 0), data, offsets, lengths)  # foreground
        t.join()
        elapsed = _time.monotonic() - t0
        assert elapsed < 3.0, f"priority inversion: fg pin stalled {elapsed:.1f}s"

    def test_unreserved_stream_never_grows_past_budget(self):
        """Without reserve(), eviction bounds LIVE chunks but growth used to
        park the PHYSICAL matrix at up to ~2x capacity_bytes (compaction
        only fires at dead*2 >= used) — an OOM on a chip sized to the
        budget. Growth now clamps at the budget ceiling and the shape
        freezes there (reclaim-in-place thereafter)."""
        budget_chunks = 4096
        cache = DeviceRowCache(budget_chunks * CHUNK_BYTES)
        rows = [{"m": f"row{i} " + "x" * 400} for i in range(300)]
        data = make_stream(rows)
        _, offsets, lengths = split_rows_arrays(data)
        caps = []
        for b in range(20):
            cache.pin((f"blk{b}".encode(), 0), data, offsets, lengths)
            caps.append(cache._bucket.cap)
        # DEVICE allocation stays under the byte budget throughout (growth
        # clamps at the budget ceiling minus host bytes; eviction +
        # compaction reclaim keep it there).
        assert max(caps) * CHUNK_BYTES <= cache.capacity_bytes, (
            max(caps) * CHUNK_BYTES, cache.capacity_bytes
        )
        # The newest block stays resident and scannable.
        last = cache.get((b"blk19", 0))
        assert last is not None
        hits = cache.scan(last, [b"row299"])
        assert hits[0].any()


class TestStreamBucket:
    def test_blocks_share_the_stream(self):
        cache = DeviceRowCache(64 << 20)
        pinned = []
        for b in range(4):
            rows = [{"m": f"blk{b} row{i} common"} for i in range(20)]
            data = make_stream(rows)
            buf, offs, lens = split_rows_arrays(data)
            pinned.append(cache.pin((b"f", b), data, offs, lens))
        bucket = cache._bucket
        assert len(bucket.segments) == 4
        assert bucket.used == sum(p.num_chunks for p in pinned)

    def test_scan_exact_after_eviction_and_compaction(self):
        cache = DeviceRowCache(64 << 20)
        blocks = {}
        for b in range(6):
            rows = [{"m": f"blk{b} tok{b}_{i} " + "pad" * 40} for i in range(30)]
            data = make_stream(rows)
            buf, offs, lens = split_rows_arrays(data)
            blocks[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
        total_chunks = sum(b.num_chunks for b in blocks.values())
        for b in (0, 1, 2, 3):
            cache.invalidate_file(f"f{b}".encode())
        bucket = cache._bucket
        live_chunks = blocks[4].num_chunks + blocks[5].num_chunks
        assert len(bucket.segments) == 2
        assert bucket.used - bucket.dead == live_chunks
        assert bucket.used < total_chunks  # proof a compaction ran
        for b in (4, 5):
            scan = cache.scan(blocks[b], [f"tok{b}_13 ".encode(), b"absent"])
            assert scan[0][13], b  # zero false negatives after the move
            assert not scan[1].any(), b

    def test_concurrent_scans_share_launches(self):
        import threading

        cache = DeviceRowCache(64 << 20)
        pinned = {}
        for b in range(8):
            rows = [{"m": f"blk{b} tok{b}_{i}"} for i in range(15)]
            data = make_stream(rows)
            buf, offs, lens = split_rows_arrays(data)
            pinned[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)

        # Slow the launch so concurrent requests pile behind one leader.
        orig = cache._launch_bucket_scan

        def slow(*a, **k):
            import time as _t

            _t.sleep(0.05)
            return orig(*a, **k)

        cache._launch_bucket_scan = slow
        results = {}
        errors = []

        def one(b):
            try:
                results[b] = cache.scan(pinned[b], [f"tok{b}_7".encode(), b"absent"])
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        launches0 = cache.launches
        threads = [threading.Thread(target=one, args=(b,)) for b in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert cache.launches - launches0 < 8, "no scan batching happened"
        for b in range(8):
            assert results[b][0][7], b
            assert not results[b][1].any(), b

    def test_scan_does_not_block_behind_slow_pin(self, monkeypatch):
        """A cold pin's device upload must not stall concurrent warm scans:
        uploads run under the dedicated upload lock, scans take only the
        cache lock, and the new segment publishes after the upload lands."""
        import threading

        import bloomsearch_tpu.parallel.mesh as mesh_mod

        cache = DeviceRowCache(256 << 20, mesh_devices=1)
        cache.needle_cache_enabled = False  # force a real launch under stall
        rows = [{"m": f"warm tok_{i}"} for i in range(30)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        warm_block = cache.pin((b"warm", 0), data, offs, lens)
        # Pre-compile the scan program so the stalled-upload window below
        # measures locking, not jit time.
        cache.scan(warm_block, [b"tok_7\"", b"absent"])

        upload_started = threading.Event()
        release_upload = threading.Event()
        orig = mesh_mod.sharded_update_rows

        def slow_update(*a, **k):
            upload_started.set()
            assert release_upload.wait(timeout=10), "test deadlock"
            return orig(*a, **k)

        # The pin may route through either variant (donated for private
        # chain intermediates) — stall both.
        monkeypatch.setattr(mesh_mod, "sharded_update_rows", slow_update)
        monkeypatch.setattr(mesh_mod, "sharded_update_rows_donated", slow_update)
        rows2 = [{"m": f"cold tok2_{i}"} for i in range(30)]
        data2 = make_stream(rows2)
        _, offs2, lens2 = split_rows_arrays(data2)
        pin_done = threading.Event()

        def cold_pin():
            cache.pin((b"cold", 0), data2, offs2, lens2)
            pin_done.set()

        t = threading.Thread(target=cold_pin, daemon=True)
        t.start()
        assert upload_started.wait(timeout=10)
        # The upload is stalled mid-flight; a warm scan must still run.
        scan = cache.scan(warm_block, [b"tok_7\"", b"absent"])
        assert scan[0][7] and not scan[1].any()
        assert not pin_done.is_set(), "pin finished early; test proved nothing"
        release_upload.set()
        t.join(timeout=10)
        assert pin_done.is_set()
        # And the cold block is fully scannable afterwards.
        cold = cache.get((b"cold", 0))
        scan2 = cache.scan(cold, [b"tok2_9\""])
        assert scan2[0][9]

    def test_stale_block_after_eviction_is_conservative(self):
        cache = DeviceRowCache(64 << 20)
        rows = [{"m": f"r{i}"} for i in range(5)]
        data = make_stream(rows)
        buf, offs, lens = split_rows_arrays(data)
        block = cache.pin((b"f", 0), data, offs, lens)
        cache.invalidate_file(b"f")
        scan = cache.scan(block, [b"absent"])  # stale handle
        assert scan.all(), "stale block must be conservatively all-candidate"


def _interpret_triton(monkeypatch):
    """Route impl="triton" through the Pallas interpreter (CPU has no
    Triton compiler; the GPU always compiles the kernel)."""
    import functools

    from bloomsearch_tpu import stream_scan

    monkeypatch.setattr(
        stream_scan, "scan_triton",
        functools.partial(stream_scan.scan_triton, interpret=True),
    )


SCAN_IMPLS = ["xla", "triton"]


def _run_scan(impl, rows32, needles, *, valid_words, monkeypatch):
    """Scan int32[G, 128] chunks for byte needles with one implementation
    -> bool[len(needles), G] per-chunk hits."""
    import jax.numpy as jnp

    from bloomsearch_tpu.stream_scan import (
        MAX_SCAN_NEEDLES,
        scan_stream,
        scan_word_bucket,
    )

    if impl == "triton":
        _interpret_triton(monkeypatch)
    G = rows32.shape[0]
    out = []
    for base in range(0, len(needles), MAX_SCAN_NEEDLES):
        part = needles[base : base + MAX_SCAN_NEEDLES]
        padded = np.zeros((MAX_SCAN_NEEDLES, MAX_NEEDLE), dtype=np.int32)
        lens = np.zeros(MAX_SCAN_NEEDLES, dtype=np.int32)
        for r, nd in enumerate(part):
            padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
            lens[r] = len(nd)
        packed = np.asarray(
            scan_stream(
                jnp.asarray(rows32), jnp.asarray(padded), jnp.asarray(lens),
                impl=impl, n_real=len(part),
                max_words=scan_word_bucket(max(len(nd) for nd in part)),
                valid_words=valid_words,
            )
        )
        bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little")
        out.append(bits[:, :G].astype(bool))
    return np.concatenate(out, axis=0)


def _byte_oracle(rows_u8: np.ndarray, needle: bytes, max_start: int) -> np.ndarray:
    """bool[G]: chunk g holds ``needle`` at some start byte < max_start."""
    out = np.zeros(rows_u8.shape[0], dtype=bool)
    for g in range(rows_u8.shape[0]):
        pos = rows_u8[g].tobytes().find(needle)
        out[g] = 0 <= pos < max_start
    return out


class TestPallasByteScanParity:
    def test_pallas_interpret_matches_xla_path(self, monkeypatch):
        """The Triton-route scan kernel (Pallas interpreter on CPU) must
        match the plain-jnp SWAR scan bit for bit through the row cache,
        and both must match the chunk-expansion oracle."""
        rng = random.Random(11)
        words = ["Alpha", "beta", "GAMMA-7", "needle one", "Ka", "MiXeD"]
        rows = [
            {"m": " ".join(rng.choice(words) for _ in range(rng.randrange(1, 5)))}
            for _ in range(150)
        ]
        data = make_stream(rows)
        buf, offsets, lengths = split_rows_arrays(data)
        needles = [b"alpha", b"gamma-7", b"needle one", b"absent", b"ka"]

        xla_cache = DeviceRowCache(64 << 20)
        xla_cache.scan_impl = "xla"
        px = xla_cache.pin((b"f", 0), data, offsets, lengths)
        xla_scan = xla_cache.scan(px, needles)

        _interpret_triton(monkeypatch)
        tr_cache = DeviceRowCache(64 << 20)
        tr_cache.scan_impl = "triton"
        pt = tr_cache.pin((b"f", 0), data, offsets, lengths)
        tr_scan = tr_cache.scan(pt, needles)

        np.testing.assert_array_equal(xla_scan, tr_scan)
        for qi, nd in enumerate(needles):
            np.testing.assert_array_equal(
                tr_scan[qi], chunk_oracle(data, offsets, lengths, nd),
                err_msg=repr(nd),
            )


class TestSwarKernelFuzz:
    @pytest.mark.parametrize("impl", SCAN_IMPLS)
    def test_swar_alignments_lengths_and_high_bytes(self, impl, monkeypatch):
        """Scan fuzz vs a bytes-in oracle: every start alignment mod 4,
        needle lengths 1..32 (the packed-word spans 1..9), bytes >= 0x80
        (sign bits in the int32 words), and matches flush against the
        valid-start boundary."""
        rng = np.random.default_rng(7)
        G, P = 128, CHUNK_BYTES
        rows = rng.integers(0, 256, size=(G, P), dtype=np.uint8)
        needles = []
        for ln in (1, 2, 3, 4, 5, 7, 8, 31, 32):
            nd = bytes(rng.integers(0, 256, size=ln, dtype=np.uint8))
            needles.append(nd)
        # Plant occurrences at every alignment and at the last legal start.
        for nd in needles:
            for a in range(4):
                g = rng.integers(0, G)
                s = int(rng.integers(0, (STREAM_STRIDE - 4) // 4)) * 4 + a
                rows[g, s : s + len(nd)] = np.frombuffer(nd, np.uint8)
            g = rng.integers(0, G)
            s = STREAM_STRIDE - 1
            rows[g, s : s + len(nd)] = np.frombuffer(nd, np.uint8)

        hits = _run_scan(
            impl, rows.view(np.int32), needles,
            valid_words=STREAM_STRIDE // 4, monkeypatch=monkeypatch,
        )
        for r, nd in enumerate(needles):
            np.testing.assert_array_equal(
                hits[r], _byte_oracle(rows, nd, STREAM_STRIDE), err_msg=repr(nd)
            )

    @pytest.mark.parametrize("impl", SCAN_IMPLS)
    def test_stream_stride_valid_start_boundary(self, impl, monkeypatch):
        """Stream-chunk mode: matches STARTING in the payload region
        (< stride) hit; matches starting in the overlap tail belong to the
        next chunk and must NOT hit this one."""
        rng = np.random.default_rng(23)
        G, P = 64, CHUNK_BYTES
        rows = rng.integers(97, 123, size=(G, P), dtype=np.uint8)
        ndl = b"xyzzy-needle"  # '-' is outside the random a-z alphabet
        # chunk 3: starts exactly at the last valid payload byte
        rows[3, STREAM_STRIDE - 1 : STREAM_STRIDE - 1 + len(ndl)] = np.frombuffer(
            ndl, np.uint8
        )
        # chunk 7: starts at the first overlap byte -> must NOT hit
        rows[7, STREAM_STRIDE : STREAM_STRIDE + len(ndl)] = np.frombuffer(
            ndl, np.uint8
        )
        # chunk 11: starts at payload byte 0
        rows[11, : len(ndl)] = np.frombuffer(ndl, np.uint8)

        hits = _run_scan(
            impl, rows.view(np.int32), [ndl],
            valid_words=STREAM_STRIDE // 4, monkeypatch=monkeypatch,
        )
        expect = np.zeros(G, dtype=bool)
        expect[3] = expect[11] = True
        np.testing.assert_array_equal(hits[0], expect)


class TestScanWordBuckets:
    @pytest.mark.parametrize("wb", [2, 4, 6, 9])
    @pytest.mark.parametrize("impl", SCAN_IMPLS)
    def test_longest_needle_of_each_word_bucket(self, impl, wb, monkeypatch):
        """A launch's word loop stops at its bucket: the longest needle a
        bucket admits must still match at all four alignments (a span of
        exactly ``wb`` words at alignment 3), and one byte off at its last
        position must not."""
        from bloomsearch_tpu.stream_scan import scan_word_bucket

        ln = min(4 * wb - 3, MAX_NEEDLE)
        assert scan_word_bucket(ln) == wb
        rng = np.random.default_rng(100 + wb)
        G = 64
        rows = rng.integers(97, 123, size=(G, CHUNK_BYTES), dtype=np.uint8)
        nd = bytes([0xC3, ord("-")]) + bytes(rng.integers(97, 123, size=ln - 2, dtype=np.uint8))
        near = nd[:-1] + bytes([nd[-1] ^ 0x01])
        for a in range(4):
            s = 40 * (a + 1) + a
            rows[a * 5, s : s + ln] = np.frombuffer(nd, np.uint8)
            rows[a * 5 + 1, s : s + ln] = np.frombuffer(near, np.uint8)
        hits = _run_scan(
            impl, rows.view(np.int32), [nd],
            valid_words=STREAM_STRIDE // 4, monkeypatch=monkeypatch,
        )
        expect = _byte_oracle(rows, nd, STREAM_STRIDE)
        assert expect.sum() == 4
        np.testing.assert_array_equal(hits[0], expect)


class TestStreamChunkBoundary:
    @pytest.mark.parametrize("impl", SCAN_IMPLS)
    def test_high_bytes_at_chunk_boundary(self, impl, monkeypatch):
        """Needles of bytes >= 0x80 cut from a packed stream at starts
        around the chunk seam (stride - 1, stride, stride + 1): each must
        hit exactly the chunks whose payload holds an occurrence's start —
        the overlap bytes duplicated from the next chunk never double-count
        and never hide a match."""
        rng = np.random.default_rng(5)
        n = 40 * STREAM_STRIDE
        data = bytes(rng.integers(0x80, 0x100, size=n, dtype=np.uint8))
        chunks, _ = _pack_stream_numpy(
            data, np.array([0], np.int64), np.array([n], np.int64)
        )
        G = _round_up(chunks.shape[0], 32)
        rows = np.zeros((G, CHUNK_BYTES), dtype=np.uint8)
        rows[: chunks.shape[0]] = chunks
        needles = []
        for seam in (3, 9, 17):
            for d in (-1, 0, 1):
                s = seam * STREAM_STRIDE + d
                needles.append(data[s : s + 7 + seam])
        hits = _run_scan(
            impl, rows.view(np.int32), needles,
            valid_words=STREAM_STRIDE // 4, monkeypatch=monkeypatch,
        )
        buf = np.frombuffer(data, np.uint8)
        for r, nd in enumerate(needles):
            starts = [
                s for s in range(n - len(nd) + 1)
                if buf[s] == nd[0] and data[s : s + len(nd)] == nd
            ]
            expect = np.zeros(G, dtype=bool)
            expect[[s // STREAM_STRIDE for s in starts]] = True
            np.testing.assert_array_equal(hits[r], expect, err_msg=repr(nd))


class TestSparseSegmentScan:
    def test_sparse_request_on_big_stream_is_exact(self):
        """A scan touching few blocks of a big stream takes the
        dynamic-slice segment path; results must match the dense scan-all
        path bit for bit."""
        # mesh_devices=1: the sparse path is single-device only (a mesh
        # always scans its shards in full).
        cache = DeviceRowCache(1 << 30, mesh_devices=1)
        cache.needle_cache_enabled = False
        blocks = {}
        datas = {}
        NB, RPB = 40, 600
        for b in range(NB):
            rows = [{"m": f"blk{b} tok{b}_{i} " + "x" * 90} for i in range(RPB)]
            data = make_stream(rows)
            buf, offs, lens = split_rows_arrays(data)
            blocks[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
            datas[b] = (data, offs, lens)
        bucket = cache._bucket
        # Requesting 1-2 blocks of this stream must qualify as sparse.
        seg_chunks = max(512, 1 << (blocks[0].num_chunks - 1).bit_length())
        assert 2 * seg_chunks * 4 <= bucket.cap, (
            "test no longer exercises the sparse path; grow the stream")

        for b in (0, 17, NB - 1):
            needles = [f"tok{b}_7 ".encode(), b"absent", f"blk{b} ".encode()]
            scan = cache.scan(blocks[b], needles)
            data, offs, lens = datas[b]
            for qi, nd in enumerate(needles):
                np.testing.assert_array_equal(
                    scan[qi], chunk_oracle(data, offs, lens, nd), err_msg=(b, nd)
                )
            assert scan[0][7], b
            assert not scan[1].any(), b
            assert scan[2].all(), b
        # Two blocks in one request (two segments, one launch).
        out = cache.scan_many([blocks[3], blocks[29]], [b"tok3_11 ", b"tok29_0 "])
        assert out[blocks[3].key][0][11]
        assert not out[blocks[3].key][1].any()
        assert out[blocks[29].key][1][0]
        # Dense path (every block requested) agrees with the sparse slices.
        dense = cache.scan_many(list(blocks.values()), [b"tok17_7 "])
        sparse = cache.scan(blocks[17], [b"tok17_7 "])
        np.testing.assert_array_equal(dense[blocks[17].key][0], sparse[0])


class TestNeedleBitmapCache:
    def test_repeat_needle_skips_launch_until_matrix_changes(self):
        cache = DeviceRowCache(64 << 20)
        rows = [{"m": f"tok{i} filler"} for i in range(40)]
        data = make_stream(rows)
        buf, offs, lens = split_rows_arrays(data)
        b0 = cache.pin((b"f0", 0), data, offs, lens)

        first = cache.scan(b0, [b"tok7 "])
        launches = cache.launches
        second = cache.scan(b0, [b"tok7 "])
        assert cache.launches == launches, "cached needle re-launched"
        np.testing.assert_array_equal(first, second)
        assert second[0][7]

        # New pin changes the matrix -> version bump -> cache invalid.
        rows2 = [{"m": f"other{i}"} for i in range(10)]
        data2 = make_stream(rows2)
        _, offs2, lens2 = split_rows_arrays(data2)
        cache.pin((b"f1", 0), data2, offs2, lens2)
        third = cache.scan(b0, [b"tok7 "])
        assert cache.launches == launches + 1, "stale cache served after pin"
        np.testing.assert_array_equal(first, third)

    def test_disabled_cache_always_launches(self):
        cache = DeviceRowCache(64 << 20)
        cache.needle_cache_enabled = False
        rows = [{"m": f"tok{i}"} for i in range(10)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        b0 = cache.pin((b"f0", 0), data, offs, lens)
        cache.scan(b0, [b"tok3"])
        launches = cache.launches
        cache.scan(b0, [b"tok3"])
        assert cache.launches == launches + 1


class TestNeedleCacheByteCap:
    def test_cache_capped_by_total_bytes(self, monkeypatch):
        """The entry-count cap alone let multi-GB streams hold
        hundreds of MB of bitmaps; a byte cap must bound it."""
        import bloomsearch_tpu.rowcache as rc_mod

        cache = DeviceRowCache(64 << 20)
        rows = [{"m": f"tok{i} word"} for i in range(500)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        b0 = cache.pin((b"f0", 0), data, offs, lens)
        # One entry's packed bitmap is cap/8 bytes; cap the budget at ~3.
        per_entry = -(-cache._bucket.cap // 32) * 4
        monkeypatch.setattr(rc_mod, "_NEEDLE_CACHE_MAX_BYTES", per_entry * 3)
        for i in range(10):
            cache.scan(b0, [b"tok%d " % i])
        n = len(cache._bucket.needle_cache)
        assert 1 <= n <= 3, n
        # Cached entries still serve correct hits.
        launches = cache.launches
        out = cache.scan(b0, [b"tok9 "])
        assert cache.launches == launches and out[0][9]


class TestReserve:
    def test_reserve_fixes_shape_and_rounds_down_to_budget(self):
        cache = DeviceRowCache(300 << 10, mesh_devices=1)  # 300 KB device budget
        got = cache.reserve(10_000_000)  # dataset far beyond budget
        # Budget cap rounds DOWN to the 512-chunk unit: never overshoots.
        assert got * 512 <= int(300 << 10 * 1)  # bytes within budget
        assert got % 512 == 0
        assert cache._reserved_cap == got == cache._bucket.cap
        assert cache.stream_free_chunks() == got

    def test_reserve_small_dataset_covers_it(self):
        cache = DeviceRowCache(1 << 30, mesh_devices=1)
        got = cache.reserve(100)  # tiny dataset
        assert got >= 100 + 512 or got == 512 * 2  # rounded to unit
        # Pins within the reservation never change the cap.
        rows = [{"m": f"r{i} data"} for i in range(50)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        cache.pin((b"a", 0), data, offs, lens)
        cache.pin((b"b", 0), data, offs, lens)
        assert cache._bucket.cap == got

    def test_churn_keeps_shape_at_reserved_cap(self):
        cache = DeviceRowCache(600 << 10, mesh_devices=1)
        got = cache.reserve(10_000_000)
        # ~64 KB per block; reservation holds ~8; pin 24 -> forced churn.
        rows = [{"m": "x" * 120 + f" blk r{i}"} for i in range(500)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        for b in range(24):
            cache.pin((b"f%d" % b, 0), data, offs, lens)
        assert cache._bucket.cap == got  # shape never moved
        assert cache.evictions > 0 and cache.compactions > 0
        # The most recent block survives and scans correctly.
        last = cache.get((b"f23", 0))
        assert last is not None
        out = cache.scan(last, [b"blk r7"])
        assert out[0].any()

    def test_slack_eviction_amortizes_compaction(self):
        """At-capacity pins evict with cap/8 slack so the full-stream
        compaction gather runs once per ~slack of churn, not once per pin.
        (Needs a cap comfortably above the 512-chunk upload-piece floor —
        at tiny caps the piece granularity eats any slack.)"""
        cache = DeviceRowCache(8 << 20, mesh_devices=1)
        cache.reserve(10_000_000)  # caps at ~90% of the 8 MB budget
        rows = [{"m": "x" * 120 + f" slk r{i}"} for i in range(500)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        for b in range(200):  # ~64 KB per block; ~2x capacity of churn
            cache.pin((b"s%d" % b, 0), data, offs, lens)
        assert cache.compactions > 0
        assert cache.compactions <= 200 // 4
        last = cache.get((b"s199", 0))
        assert last is not None
        assert cache.scan(last, [b"slk r7"])[0].any()


class TestRelease:
    def test_release_frees_device_bytes_and_closes(self):
        """release() must drop the stream matrix (device bytes -> 0) and
        fail later pins fast — the engine calls it at stop() so the next
        engine in the process starts with a near-empty device."""
        cache = DeviceRowCache(8 << 20)
        rows = [{"m": f"rel row {i}"} for i in range(50)]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        cache.pin((b"rel", 0), data, offs, lens)
        assert cache.stats()["device_bytes"] > 0
        cache.release()
        st = cache.stats()
        assert st["device_bytes"] == 0
        assert st["pinned_blocks"] == 0
        with pytest.raises(RuntimeError, match="released"):
            cache.pin((b"rel2", 0), data, offs, lens)
        with pytest.raises(RuntimeError, match="released"):
            cache.reserve(1000)
        cache.release()  # idempotent

    def test_engine_stop_releases_device_caches(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path))
        cfg = bs.BloomSearchEngineConfig(row_cache_bytes=8 << 20)
        eng = bs.BloomSearchEngine(cfg, store, store)
        eng.start()
        eng.ingest_rows([{"m": f"stoprel {i}"} for i in range(500)])
        eng.flush()
        out = eng.query_sync(bs.new_query().token("stoprel").build())
        assert len(out) == 500
        rc, backend = eng._row_cache, eng._device_backend
        eng.stop()
        if rc is not None:
            assert rc.stats()["device_bytes"] == 0
        if backend is not None:
            assert backend.total_bytes() == 0


class TestChurnAdmission:
    def test_bg_pins_rate_limited_at_capacity(self, tmp_path):
        """Once the stream reservation is full, background pins admit only
        within the churn budget (~5% capacity/min, starting empty): a
        scan-shaped workload stops evict/upload-thrashing the warm set."""
        store = bs.FileSystemDataStore(str(tmp_path))
        cfg = bs.BloomSearchEngineConfig(
            row_cache_bytes=4 << 20, probe_backend="device"
        )
        eng = bs.BloomSearchEngine(cfg, store, store)
        eng.start()
        try:
            rc = eng._row_cache
            assert rc is not None
            rc.reserve(10_000_000)  # caps at ~90% of the 4 MB budget
            # While free space remains, pins always admit.
            assert eng._bg_churn_admit(1000)
            # Fill the reservation.
            rows = [{"m": "churn filler " + "y" * 100 + f" r{i}"} for i in range(300)]
            data = make_stream(rows)
            _, offs, lens = split_rows_arrays(data)
            b = 0
            while (rc.stream_free_chunks() or 0) > 1024:
                rc.pin((b"churn%d" % b, 0), data, offs, lens)
                b += 1
            # At capacity with an empty token bucket: denied and counted.
            assert not eng._bg_churn_admit(1 << 20)
            assert eng.stats()["background_pins_churn_skipped"] == 1
            # Refill: backdate the bucket one minute -> one full burst
            # (~5% of 4 MB = ~205 KB) accrues. A request LARGER than the
            # burst still admits — deficit bucket: tokens go negative so a
            # single big block can migrate while the long-run rate stays
            # exact (`tokens >= nbytes` would deny it forever)...
            eng._pin_churn.t -= 60.0
            assert eng._bg_churn_admit(1 << 20)
            assert eng._pin_churn.tokens < 0
            # ...and nothing else admits until the deficit repays (300 KB
            # needs >1024 chunks, so this can't slip through free space).
            assert not eng._bg_churn_admit(300_000)
            # ~7 min repays the ~840 KB deficit plus a fresh burst.
            eng._pin_churn.t -= 420.0
            assert eng._bg_churn_admit(300_000)
        finally:
            eng.stop()

    def test_bank_warm_churn_budget(self, tmp_path):
        """A sparse-probed group whose load would overflow the bank cache
        is not rescheduled for a full load once the churn budget is spent
        (sparse probes remain correct; only the residency warm is skipped)."""
        store = bs.FileSystemDataStore(str(tmp_path))
        cfg = bs.BloomSearchEngineConfig(probe_backend="device")
        eng = bs.BloomSearchEngine(cfg, store, store)
        eng.start()
        try:
            eng._device_backend.cache_bytes = 0  # any load would evict

            class G:
                size = 10 << 20
                offset = 0

            before = eng.stats()["bank_warms_churn_skipped"]
            eng._schedule_bank_warm(b"ptr", 0, G())
            assert eng.stats()["bank_warms_churn_skipped"] == before + 1
            assert not eng._warming  # nothing scheduled
        finally:
            eng.stop()


class TestMeshShardedRowCache:
    def test_stream_shards_across_devices(self):
        import jax

        assert len(jax.devices()) == 8
        cache = DeviceRowCache(64 << 20)  # auto mesh over all 8 CPU devices
        assert cache.mesh is not None and cache.mesh.shape["blocks"] == 8
        blocks = {}
        for b in range(4):
            rows = [{"m": f"blk{b} tok{b}_{i}"} for i in range(25)]
            data = make_stream(rows)
            buf, offs, lens = split_rows_arrays(data)
            blocks[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
        bucket = cache._bucket
        assert len(bucket.matrix.sharding.device_set) == 8, bucket.matrix.sharding
        assert bucket.cap % (512 * 8) == 0

        # Exact scans over the sharded stream, including after
        # tombstone-driven compaction.
        for b in (0, 1):
            cache.invalidate_file(f"f{b}".encode())
        for b in (2, 3):
            scan = cache.scan(blocks[b], [f"tok{b}_11".encode(), b"absent"])
            assert scan[0][11]
            assert not scan[1].any()
        assert len(bucket.matrix.sharding.device_set) == 8

    def test_mesh_devices_one_disables(self):
        cache = DeviceRowCache(64 << 20, mesh_devices=1)
        assert cache.mesh is None
        rows = [{"m": "solo needle"}]
        data = make_stream(rows)
        _, offs, lens = split_rows_arrays(data)
        pinned = cache.pin((b"f", 0), data, offs, lens)
        assert cache.scan(pinned, [b"needle"])[0, 0]


class TestUnpackBitRange:
    def test_matches_full_unpack_at_random_offsets(self):
        import numpy as np

        from bloomsearch_tpu.rowcache import _unpack_bit_range

        rng = np.random.default_rng(11)
        raw = rng.integers(0, 256, size=4096, dtype=np.uint8)
        full = np.unpackbits(raw, bitorder="little").astype(bool)
        for _ in range(200):
            start = int(rng.integers(0, raw.size * 8 - 1))
            n = int(rng.integers(0, min(2048, raw.size * 8 - start)))
            np.testing.assert_array_equal(
                _unpack_bit_range(raw, start, n), full[start : start + n]
            )
        assert _unpack_bit_range(raw, 17, 0).shape == (0,)
