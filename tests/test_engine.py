"""Engine integration tests: real engine + real filesystem store.

Mirrors the reference's bloom_tree_engine_test.go structure: flush triggers
(:123-292), E2E ingest→flush→query per compression (:469-984), graceful-stop
flushing (:2313-2395), bounded concurrency (:2030-2108), and the
evaluate-bloom unit semantics (:382-467).
"""

import queue
import threading
import time

import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu import (
    BloomSearchEngine,
    BloomSearchEngineConfig,
    FileSystemDataStore,
)

TIMEOUT = 10.0


def make_engine(tmp_path, **overrides) -> tuple[BloomSearchEngine, FileSystemDataStore]:
    store = FileSystemDataStore(str(tmp_path / "data"))
    config = BloomSearchEngineConfig(row_data_compression="none", **overrides)
    engine = BloomSearchEngine(config, store, store)
    engine.start()
    return engine, store


def ingest_and_flush(engine: BloomSearchEngine, rows):
    engine.ingest_rows(rows, timeout=TIMEOUT)
    engine.flush(timeout=TIMEOUT)


SAMPLE_ROWS = [
    {"service": "payment", "level": "error", "message": "connection timeout", "retry_count": 3},
    {"service": "auth", "level": "info", "message": "user login ok", "user": {"name": "John Doe"}},
    {"service": "payment", "level": "info", "message": "charge ok", "amount": 42.5},
]


class TestLifecycle:
    def test_start_stop(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        engine.stop(timeout=TIMEOUT)

    def test_stop_flushes_buffered_rows(self, tmp_path):
        # Reference guarantee: rows buffered at Stop time land in a complete
        # file before return (bloom_tree_engine_test.go:2313-2395).
        engine, store = make_engine(tmp_path)
        engine.ingest_rows(SAMPLE_ROWS, timeout=TIMEOUT)
        engine.stop(timeout=TIMEOUT)
        files = store.get_maybe_files_for_query(None)
        assert len(files) == 1
        assert sum(b.rows for b in files[0].metadata.data_blocks) == len(SAMPLE_ROWS)

    def test_double_start_rejected(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        with pytest.raises(RuntimeError):
            engine.start()
        engine.stop(timeout=TIMEOUT)

    def test_ingest_after_stop_rejected(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        engine.stop(timeout=TIMEOUT)
        with pytest.raises(RuntimeError):
            engine.ingest_rows(SAMPLE_ROWS)


class TestConfigValidation:
    def test_bad_fpr(self):
        with pytest.raises(bs.InvalidConfigError):
            BloomSearchEngine(
                BloomSearchEngineConfig(bloom_false_positive_rate=1.5),
                bs.NullMetaStore(),
                bs.NullDataStore(),
            )

    def test_bad_concurrency(self):
        with pytest.raises(bs.InvalidConfigError):
            BloomSearchEngine(
                BloomSearchEngineConfig(max_query_concurrency=0),
                bs.NullMetaStore(),
                bs.NullDataStore(),
            )

    def test_unknown_compression(self):
        with pytest.raises(bs.InvalidConfigError):
            BloomSearchEngine(
                BloomSearchEngineConfig(row_data_compression="lz77"),
                bs.NullMetaStore(),
                bs.NullDataStore(),
            )

    def test_missing_tokenizer(self):
        with pytest.raises(bs.InvalidConfigError):
            BloomSearchEngine(
                BloomSearchEngineConfig(tokenizer=None),
                bs.NullMetaStore(),
                bs.NullDataStore(),
            )


class TestFlushTriggers:
    def test_flush_on_max_buffered_rows(self, tmp_path):
        engine, store = make_engine(tmp_path, max_buffered_rows=10)
        done_fut = None
        from concurrent.futures import Future

        done_fut = Future()
        engine.ingest_rows([{"n": i} for i in range(10)], done=done_fut, timeout=TIMEOUT)
        done_fut.result(timeout=TIMEOUT)  # resolves only after durable flush
        files = store.get_maybe_files_for_query(None)
        assert len(files) == 1
        engine.stop(timeout=TIMEOUT)

    def test_flush_on_max_buffered_bytes(self, tmp_path):
        engine, store = make_engine(tmp_path, max_buffered_bytes=200)
        from concurrent.futures import Future

        done_fut = Future()
        engine.ingest_rows(
            [{"payload": "x" * 100} for _ in range(5)], done=done_fut, timeout=TIMEOUT
        )
        done_fut.result(timeout=TIMEOUT)
        assert len(store.get_maybe_files_for_query(None)) == 1
        engine.stop(timeout=TIMEOUT)

    def test_flush_on_max_buffered_time(self, tmp_path):
        engine, store = make_engine(tmp_path, max_buffered_time=0.3)
        engine.ingest_rows([{"n": 1}], timeout=TIMEOUT)
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            if store.get_maybe_files_for_query(None):
                break
            time.sleep(0.05)
        assert len(store.get_maybe_files_for_query(None)) == 1
        engine.stop(timeout=TIMEOUT)

    def test_flush_on_row_group_rows(self, tmp_path):
        # Partition cap triggers a flush even below the buffer caps.
        engine, store = make_engine(
            tmp_path, max_row_group_rows=5, max_buffered_rows=1_000_000
        )
        from concurrent.futures import Future

        done_fut = Future()
        engine.ingest_rows([{"n": i} for i in range(5)], done=done_fut, timeout=TIMEOUT)
        done_fut.result(timeout=TIMEOUT)
        assert len(store.get_maybe_files_for_query(None)) == 1
        engine.stop(timeout=TIMEOUT)

    def test_forced_flush_with_empty_buffer_completes(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        engine.flush(timeout=TIMEOUT)  # no data: resolves immediately
        engine.stop(timeout=TIMEOUT)

    def test_flush_is_a_durability_barrier_after_auto_flush(self, tmp_path):
        # Regression: an ingest that trips max_buffered_rows queues an async
        # flush; a subsequent Flush() with an empty buffer must not ack until
        # that earlier flush is durable.
        engine, store = make_engine(tmp_path, max_buffered_rows=10)
        engine.ingest_rows([{"n": i} for i in range(10)], timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        files = store.get_maybe_files_for_query(None)
        assert len(files) == 1
        assert sum(b.rows for b in files[0].metadata.data_blocks) == 10
        engine.stop(timeout=TIMEOUT)


class TestEndToEndQueries:
    @pytest.mark.parametrize("compression", ["none", "zstd"])
    def test_ingest_flush_query_round_trip(self, tmp_path, compression):
        store = FileSystemDataStore(str(tmp_path / "data"))
        config = BloomSearchEngineConfig(row_data_compression=compression)
        engine = BloomSearchEngine(config, store, store)
        engine.start()
        try:
            ingest_and_flush(engine, SAMPLE_ROWS)

            # token search
            rows = engine.query_sync(bs.new_query().token("timeout").build(), timeout=TIMEOUT)
            assert len(rows) == 1
            assert rows[0]["service"] == "payment"

            # field search
            rows = engine.query_sync(bs.new_query().field("user.name").build(), timeout=TIMEOUT)
            assert len(rows) == 1
            assert rows[0]["service"] == "auth"

            # field:token search
            rows = engine.query_sync(
                bs.new_query().field_token("service", "payment").build(), timeout=TIMEOUT
            )
            assert len(rows) == 2

            # no match
            rows = engine.query_sync(bs.new_query().token("nonexistent").build(), timeout=TIMEOUT)
            assert rows == []

            # match-all (no conditions)
            rows = engine.query_sync(None, timeout=TIMEOUT)
            assert len(rows) == 3
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_and_or_expression_trees(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        try:
            ingest_and_flush(engine, SAMPLE_ROWS)
            q = (
                bs.new_query()
                .match(
                    bs.or_(
                        bs.field_token("level", "error"),
                        bs.and_(
                            bs.field_token("service", "auth"),
                            bs.token("login"),
                        ),
                    )
                )
                .build()
            )
            rows = engine.query_sync(q, timeout=TIMEOUT)
            assert len(rows) == 2
            services = sorted(r["service"] for r in rows)
            assert services == ["auth", "payment"]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_results_across_multiple_files(self, tmp_path):
        engine, store = make_engine(tmp_path)
        try:
            for i in range(3):
                ingest_and_flush(engine, [{"batch": i, "tag": "common"}])
            assert len(store.get_maybe_files_for_query(None)) == 3
            rows = engine.query_sync(bs.new_query().token("common").build(), timeout=TIMEOUT)
            assert len(rows) == 3
            assert sorted(r["batch"] for r in rows) == [0, 1, 2]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_exact_results_zero_false_positives(self, tmp_path):
        # Needle-in-haystack: bloom FPR may pass blocks, but row verification
        # must make final results exact.
        engine, _ = make_engine(tmp_path)
        try:
            rows = [{"id": i, "word": f"word{i}"} for i in range(500)]
            rows.append({"id": 9999, "word": "needle"})
            ingest_and_flush(engine, rows)
            result = engine.query_sync(bs.new_query().token("needle").build(), timeout=TIMEOUT)
            assert len(result) == 1
            assert result[0]["id"] == 9999
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_query_streaming_api(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        try:
            ingest_and_flush(engine, SAMPLE_ROWS)
            result_q: queue.Queue = queue.Queue()
            error_q: queue.Queue = queue.Queue()
            stats_q: queue.Queue = queue.Queue()
            engine.query(bs.new_query().token("timeout").build(), result_q, error_q, stats_q)
            rows = []
            while True:
                item = result_q.get(timeout=TIMEOUT)
                if item is None:
                    break
                rows.append(item)
            assert len(rows) == 1
            assert error_q.empty()
            stats = []
            while not stats_q.empty():
                stats.append(stats_q.get_nowait())
            assert stats, "expected block stats"
            assert any(s.rows_processed > 0 for s in stats)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_invalid_regex_raises_synchronously(self, tmp_path):
        import re

        engine, _ = make_engine(tmp_path)
        try:
            ingest_and_flush(engine, SAMPLE_ROWS)
            q = bs.new_query().field_regex("message", "[bad(").build()
            with pytest.raises(re.error):
                engine.query_sync(q, timeout=TIMEOUT)
        finally:
            engine.stop(timeout=TIMEOUT)


class TestPartitionsAndMinMax:
    def test_partitioned_ingest_separate_blocks(self, tmp_path):
        engine, store = make_engine(
            tmp_path, partition_func=lambda row: row["tenant"]
        )
        try:
            ingest_and_flush(
                engine,
                [
                    {"tenant": "a", "v": 1},
                    {"tenant": "b", "v": 2},
                    {"tenant": "a", "v": 3},
                ],
            )
            files = store.get_maybe_files_for_query(None)
            assert len(files) == 1
            blocks = files[0].metadata.data_blocks
            assert sorted(b.partition_id for b in blocks) == ["a", "b"]
            by_partition = {b.partition_id: b.rows for b in blocks}
            assert by_partition == {"a": 2, "b": 1}
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_partition_prefilter_prunes(self, tmp_path):
        engine, _ = make_engine(tmp_path, partition_func=lambda row: row["tenant"])
        try:
            ingest_and_flush(
                engine, [{"tenant": "a", "v": 1}, {"tenant": "b", "v": 2}]
            )
            q = (
                bs.new_query()
                .match_prefilter(bs.partition(bs.partition_equals("a")))
                .build()
            )
            rows = engine.query_sync(q, timeout=TIMEOUT)
            assert len(rows) == 1 and rows[0]["tenant"] == "a"
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_minmax_prefilter_prunes(self, tmp_path):
        engine, store = make_engine(tmp_path, min_max_indexes=["ts"])
        try:
            ingest_and_flush(engine, [{"ts": 100, "v": "low"}])
            ingest_and_flush(engine, [{"ts": 5000, "v": "high"}])

            q = (
                bs.new_query()
                .match_prefilter(bs.min_max("ts", bs.numeric_between(4000, 6000)))
                .build()
            )
            rows = engine.query_sync(q, timeout=TIMEOUT)
            assert len(rows) == 1 and rows[0]["v"] == "high"

            # Strict semantics: condition on unindexed field matches nothing.
            q = (
                bs.new_query()
                .match_prefilter(bs.min_max("missing", bs.numeric_equals(1)))
                .build()
            )
            assert engine.query_sync(q, timeout=TIMEOUT) == []
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_minmax_metadata_recorded(self, tmp_path):
        engine, store = make_engine(tmp_path, min_max_indexes=["ts"])
        try:
            ingest_and_flush(engine, [{"ts": 10}, {"ts": 99}, {"ts": 42.5}])
            files = store.get_maybe_files_for_query(None)
            index = files[0].metadata.data_blocks[0].min_max_indexes["ts"]
            assert index.min == 10
            assert index.max == 99
        finally:
            engine.stop(timeout=TIMEOUT)


class TestConcurrencyBound:
    def test_semaphore_bounds_concurrent_blocks(self, tmp_path):
        # Reference test at concurrency 2 over many blocks (:2030-2108).
        engine, store = make_engine(
            tmp_path, max_query_concurrency=2, partition_func=lambda row: str(row["p"])
        )
        try:
            # 8 partitions -> 8 blocks in one file.
            ingest_and_flush(engine, [{"p": i, "tag": "x"} for i in range(8)])
            blocks = sum(
                len(f.metadata.data_blocks) for f in store.get_maybe_files_for_query(None)
            )
            assert blocks == 8

            active = 0
            max_active = 0
            lock = threading.Lock()
            original_process = engine._process_data_block

            def tracking_process(*args, **kwargs):
                nonlocal active, max_active
                with lock:
                    active += 1
                    max_active = max(max_active, active)
                time.sleep(0.02)
                try:
                    return original_process(*args, **kwargs)
                finally:
                    with lock:
                        active -= 1

            engine._process_data_block = tracking_process
            rows = engine.query_sync(bs.new_query().token("x").build(), timeout=TIMEOUT)
            assert len(rows) == 8
            assert max_active <= 2, f"semaphore violated: {max_active} concurrent blocks"
        finally:
            engine.stop(timeout=TIMEOUT)


class TestKeyspaceSeparation:
    def test_filters_only_contain_their_keyspace(self, tmp_path):
        # Regression: paths must not enter the token filter etc. — a union
        # inflates FPR ~3x vs the reference's per-keyspace inserts (:551-562).
        engine, store = make_engine(tmp_path)
        try:
            ingest_and_flush(engine, [{"somefield": "sometoken"}])
            triple = store.get_maybe_files_for_query(None)[0].metadata.bloom_filters
            assert triple.field.test("somefield")
            assert not triple.field.test("sometoken")
            assert not triple.field.test("somefield::sometoken")
            assert triple.token.test("sometoken")
            assert not triple.token.test("somefield")
            assert triple.field_token.test("somefield::sometoken")
            assert not triple.field_token.test("sometoken")
        finally:
            engine.stop(timeout=TIMEOUT)


class TestBlockBloomSizing:
    def test_expected_items_override_changes_params(self, tmp_path):
        engine, store = make_engine(tmp_path, block_bloom_expected_items=200_000)
        try:
            ingest_and_flush(engine, SAMPLE_ROWS)
            block = store.get_maybe_files_for_query(None)[0].metadata.data_blocks[0]
            assert block.bloom_expected_items == 200_000
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_default_sized_by_row_group_rows(self, tmp_path):
        engine, store = make_engine(tmp_path)
        try:
            ingest_and_flush(engine, SAMPLE_ROWS)
            block = store.get_maybe_files_for_query(None)[0].metadata.data_blocks[0]
            assert block.bloom_expected_items == engine.config.max_row_group_rows
        finally:
            engine.stop(timeout=TIMEOUT)


class TestBlockStatsSkip:
    def test_bloom_skipped_blocks_reported(self, tmp_path):
        engine, _ = make_engine(tmp_path, partition_func=lambda row: str(row["p"]))
        try:
            ingest_and_flush(
                engine, [{"p": 0, "word": "alpha"}, {"p": 1, "word": "beta"}]
            )
            result_q: queue.Queue = queue.Queue()
            stats_q: queue.Queue = queue.Queue()
            engine.query(bs.new_query().token("alpha").build(), result_q, None, stats_q)
            rows = []
            while True:
                item = result_q.get(timeout=TIMEOUT)
                if item is None:
                    break
                rows.append(item)
            assert len(rows) == 1
            stats = []
            while not stats_q.empty():
                stats.append(stats_q.get_nowait())
            skipped = [s for s in stats if s.bloom_filter_skipped]
            processed = [s for s in stats if not s.bloom_filter_skipped]
            assert len(skipped) == 1  # "beta" block pruned by its bank probe
            assert len(processed) == 1
        finally:
            engine.stop(timeout=TIMEOUT)


class TestIncrementalFileBank:
    def test_columns_persist_across_file_churn(self, tmp_path):
        engine, store = make_engine(tmp_path)
        try:
            for i in range(3):
                ingest_and_flush(engine, [{"n": i, "tag": f"t{i}"}])
            assert engine.query_sync(bs.new_query().token("t1").build(), timeout=TIMEOUT)

            banks = list(engine._file_bank_cache.values())
            assert len(banks) == 1
            cols_before = dict(banks[0].cols)
            assert len(cols_before) == 3

            # A new flush must only APPEND a column; existing columns stay.
            ingest_and_flush(engine, [{"n": 3, "tag": "t3"}])
            rows = engine.query_sync(bs.new_query().token("t3").build(), timeout=TIMEOUT)
            assert [r["n"] for r in rows] == [3]
            cols_after = dict(banks[0].cols)
            for pointer, col in cols_before.items():
                assert cols_after[pointer] == col
            assert len(cols_after) == 4
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_tombstoned_file_frees_column(self, tmp_path):
        engine, store = make_engine(tmp_path)
        try:
            for i in range(3):
                ingest_and_flush(engine, [{"n": i, "tag": "common"}])
            assert len(engine.query_sync(bs.new_query().token("common").build(), timeout=TIMEOUT)) == 3
            bank = next(iter(engine._file_bank_cache.values()))
            assert len(bank.cols) == 3
            engine.merge()
            # Old columns freed; post-merge queries stay exact.
            assert len(bank.cols) == 0 and len(bank.free) >= 3
            rows = engine.query_sync(bs.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == [0, 1, 2]
            assert len(bank.cols) == 1
        finally:
            engine.stop(timeout=TIMEOUT)


class TestSaturationWarning:
    def test_flush_warns_on_saturating_block_filters(self, tmp_path, caplog):
        import logging as _logging

        # 600 rows x ~12 distinct keys each >> filters sized for 200 "rows".
        engine, _ = make_engine(tmp_path, max_row_group_rows=200, max_buffered_rows=10_000)
        try:
            rows = [
                {"a": f"u{i}", "b": f"v{i}", "c": f"w{i}", "d": f"x{i}"}
                for i in range(199)
            ]
            with caplog.at_level(_logging.WARNING, logger="bloomsearch_tpu.engine"):
                ingest_and_flush(engine, rows)
            assert any("saturating" in r.message for r in caplog.records)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_no_warning_with_honest_sizing(self, tmp_path, caplog):
        import logging as _logging

        engine, _ = make_engine(
            tmp_path, max_row_group_rows=200, block_bloom_expected_items=5_000
        )
        try:
            rows = [
                {"a": f"u{i}", "b": f"v{i}", "c": f"w{i}", "d": f"x{i}"}
                for i in range(199)
            ]
            with caplog.at_level(_logging.WARNING, logger="bloomsearch_tpu.engine"):
                ingest_and_flush(engine, rows)
            assert not any("saturating" in r.message for r in caplog.records)
        finally:
            engine.stop(timeout=TIMEOUT)


class TestRestartGuard:
    def test_start_after_stop_raises(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        engine.stop(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="restart"):
            engine.start()


class TestAutoBlockSizing:
    def test_auto_grows_filters_and_avoids_saturation(self, tmp_path, caplog):
        import logging as _logging

        engine, store = make_engine(
            tmp_path,
            block_bloom_expected_items="auto",
            max_row_group_rows=200,
            max_buffered_rows=200,  # flush every 200 rows -> new buffers learn
        )
        try:
            def batch(base):
                return [
                    {"a": f"u{base+i}", "b": f"v{base+i}", "c": f"w{base+i}", "d": f"x{base+i}"}
                    for i in range(199)
                ]

            with caplog.at_level(_logging.WARNING, logger="bloomsearch_tpu.engine"):
                # Cold start (parity sizing) until >= 500 rows observed, then
                # new buffers size from the measured keys/row.
                for base in (0, 1000, 2000, 3000, 4000):
                    ingest_and_flush(engine, batch(base))
            files = store.get_maybe_files_for_query(None)
            blocks = sorted(
                (blk for mf in files for blk in mf.metadata.data_blocks),
                key=lambda b: b.bloom_expected_items,
            )
            assert blocks[0].bloom_expected_items == 200  # cold start
            # Learned sizing: ~12 distinct keys/row * 200 rows * 1.25.
            assert blocks[-1].bloom_expected_items > 2000
            # Exactness across mixed-sized blocks, including post-merge.
            got = engine.query_sync(bs.new_query().token("u3042").build(), timeout=TIMEOUT)
            assert len(got) == 1 and got[0]["a"] == "u3042"
            engine.merge()
            got = engine.query_sync(bs.new_query().token("u4042").build(), timeout=TIMEOUT)
            assert len(got) == 1
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_invalid_auto_string_rejected(self, tmp_path):
        from bloomsearch_tpu import FileSystemDataStore

        store = FileSystemDataStore(str(tmp_path / "data"))
        with pytest.raises(Exception):
            bs.BloomSearchEngine(
                BloomSearchEngineConfig(block_bloom_expected_items="automatic"),
                store, store,
            )


class TestStatsSnapshot:
    def test_stats_reflect_runtime_state(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        config = BloomSearchEngineConfig(
            row_data_compression="none", probe_backend="device",
            row_cache_bytes=64 << 20,
        )
        engine = BloomSearchEngine(config, store, store)
        engine.start()
        try:
            s0 = engine.stats()
            assert s0["active_queries"] == 0
            assert s0["device"]["mesh_devices"] == 8
            assert s0["device"]["superbank_bytes"] == 0 or s0["device"]["superbanks"]

            ingest_and_flush(engine, [{"n": i, "w": f"word{i}"} for i in range(100)])
            for _ in range(2):
                engine.query_sync(bs.new_query().token("word7").build(), timeout=TIMEOUT)
                # Pins are async and yield to in-flight queries.
                engine.drain_background_pins(timeout=30)
            s1 = engine.stats()
            assert s1["device"]["superbank_bytes"] > 0
            assert s1["device"]["probe_launches"] >= 1
            assert s1["device"]["probe_requests"] >= s1["device"]["probe_launches"]
            assert s1["row_cache"]["pinned_blocks"] >= 1
            assert s1["row_cache"]["scan_launches"] >= 1
            import json as _json

            _json.dumps(s1)  # snapshot must be plainly serializable
        finally:
            engine.stop(timeout=TIMEOUT)


class TestYieldBudget:
    """The refilling token bucket that paces warmup's yields to queries.

    Round-5 invariants (engine._YieldBudget docstring): bounded stretch
    (paused fraction converges to ``rate`` < 1), no starvation (tokens
    refill continuously, so a query arriving late in warmup still finds
    pause allowance), and ``burst`` caps banked tokens.
    """

    def test_starts_full_and_spends_down(self):
        from bloomsearch_tpu.engine import _YieldBudget

        b = _YieldBudget(burst=1.0, rate=0.5)
        assert b.consume(0.6)
        # 0.4 left (plus negligible refill): a 0.9 s ask must be denied.
        assert not b.consume(0.9)

    def test_refills_at_rate_and_caps_at_burst(self):
        import time as _time

        from bloomsearch_tpu.engine import _YieldBudget

        b = _YieldBudget(burst=0.2, rate=0.5)
        assert b.consume(0.2)  # drain
        assert not b.consume(0.2)  # dry immediately after
        _time.sleep(0.5)  # banks ~0.25 s at rate 0.5 -> capped at 0.2
        assert b.consume(0.2)  # refilled
        # Burst cap: right after draining a full bucket there can be at
        # most ~0 banked beyond the cap, so a second full ask is denied.
        assert not b.consume(0.2)

    def test_dry_bucket_never_blocks_warmup_work(self):
        from bloomsearch_tpu.engine import _YieldBudget

        b = _YieldBudget(burst=0.05, rate=0.5)
        b.consume(0.05)
        # consume() returns False instantly when dry (the caller then does
        # one unit of warmup work) -- it must never sleep or raise.
        import time as _time

        t0 = _time.perf_counter()
        for _ in range(100):
            b.consume(1.0)
        assert _time.perf_counter() - t0 < 0.1


class TestLargeRowGroupWarning:
    """Whole-block decode is a documented divergence
    bounded by max_row_group_bytes — GB-scale configs must warn at
    construction, not OOM at query time."""

    def test_gb_scale_row_groups_warn(self, tmp_path, caplog):
        import logging

        import bloomsearch_tpu as bs

        with caplog.at_level(logging.WARNING, logger="bloomsearch_tpu.engine"):
            bs.BloomSearchEngine(
                bs.BloomSearchEngineConfig(max_row_group_bytes=1 << 30),
                bs.FileSystemDataStore(str(tmp_path)),
                bs.FileSystemDataStore(str(tmp_path)),
            )
        assert any("buffers whole blocks" in r.message for r in caplog.records)

    def test_default_cap_is_silent(self, tmp_path, caplog):
        import logging

        import bloomsearch_tpu as bs

        with caplog.at_level(logging.WARNING, logger="bloomsearch_tpu.engine"):
            bs.BloomSearchEngine(
                bs.BloomSearchEngineConfig(),
                bs.FileSystemDataStore(str(tmp_path)),
                bs.FileSystemDataStore(str(tmp_path)),
            )
        assert not any(
            "buffers whole blocks" in r.message for r in caplog.records
        )


class TestFileFilterSaturationWarning:
    """File-level mirror of the block saturation warning: a saturated file
    filter defeats file pruning (every query probes every file's block
    banks — measured as most of the 33 GB dataset's cold-query cost)."""

    def test_file_filters_warn_when_saturated(self, tmp_path, caplog):
        import logging

        import bloomsearch_tpu as bs

        store = bs.FileSystemDataStore(str(tmp_path))
        cfg = bs.BloomSearchEngineConfig(
            file_bloom_expected_items=50,  # each row adds several keys
            block_bloom_expected_items="auto",  # keep BLOCK filters honest
        )
        eng = bs.BloomSearchEngine(cfg, store, store)
        eng.start()
        try:
            rows = [
                {"uid": f"u{i:05d}", "msg": f"tok{i} alpha{i} beta{i}"}
                for i in range(2000)
            ]
            with caplog.at_level(
                logging.WARNING, logger="bloomsearch_tpu.engine"
            ):
                eng.ingest_rows(rows)
                eng.flush()
            assert any(
                "file-level" in r.message and "saturating" in r.message
                for r in caplog.records
            )
        finally:
            eng.stop()

    def test_no_file_warning_with_honest_sizing(self, tmp_path, caplog):
        import logging

        import bloomsearch_tpu as bs

        store = bs.FileSystemDataStore(str(tmp_path))
        cfg = bs.BloomSearchEngineConfig(
            file_bloom_expected_items=100_000,
            block_bloom_expected_items="auto",
        )
        eng = bs.BloomSearchEngine(cfg, store, store)
        eng.start()
        try:
            rows = [{"uid": f"u{i:05d}", "msg": f"tok{i}"} for i in range(500)]
            with caplog.at_level(
                logging.WARNING, logger="bloomsearch_tpu.engine"
            ):
                eng.ingest_rows(rows)
                eng.flush()
            assert not any(
                "file-level" in r.message for r in caplog.records
            )
        finally:
            eng.stop()
