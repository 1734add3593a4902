"""Engine warmup: banks resident + programs compiled before the first query.

Kills the cold-query cliff (the reference has none — it streams filters from
disk per query; the bank/jit design trades that for a first-touch cost that
warmup pays up front, off the query path).
"""

import queue

import pytest

import bloomsearch_tpu as bs

TIMEOUT = 30.0


def _dataset(tmp_path, rows=400):
    store = bs.FileSystemDataStore(str(tmp_path / "data"))
    engine = bs.BloomSearchEngine(
        bs.BloomSearchEngineConfig(probe_backend="host"), store, store
    )
    engine.start()
    engine.ingest_rows(
        [{"n": i, "w": f"word{i}", "tag": "all"} for i in range(rows)],
        timeout=TIMEOUT,
    )
    engine.flush(timeout=TIMEOUT)
    engine.stop(timeout=TIMEOUT)
    return store


class TestWarmup:
    def test_device_banks_resident_and_probe_compiled(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="device"), store, store
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=TIMEOUT)
            st = engine.stats()
            assert st["device"]["superbank_bytes"] > 0, st
            assert st["device"]["probe_launches"] >= 1, st  # compile pass ran
            assert st["file_bank_groups"] >= 1, st
            got = engine.query_sync(bs.new_query().token("word7").build(), timeout=TIMEOUT)
            assert got == [{"n": 7, "w": "word7", "tag": "all"}]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_host_bank_cache_warmed(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="host"), store, store
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=TIMEOUT)
            assert len(engine._host_bank_cache) >= 1
            got = engine.query_sync(bs.new_query().token("word42").build(), timeout=TIMEOUT)
            assert got == [{"n": 42, "w": "word42", "tag": "all"}]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_serving_mode_rows_pinned_and_scan_compiled(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=64 << 20
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=TIMEOUT)
            st = engine.stats()
            assert st["row_cache"]["pinned_blocks"] >= 1, st
            assert st["row_cache"]["scan_launches"] >= 1, st  # compile pass ran
            got = engine.query_sync(bs.new_query().token("word9").build(), timeout=TIMEOUT)
            assert got == [{"n": 9, "w": "word9", "tag": "all"}]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_warmup_on_start_config(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="device", warmup_on_start=True),
            store,
            store,
        )
        engine.start()
        try:
            # The background warm races this query; both orders must work.
            got = engine.query_sync(bs.new_query().token("word3").build(), timeout=TIMEOUT)
            assert got == [{"n": 3, "w": "word3", "tag": "all"}]
            # Drain the warm thread, then residency must hold.
            engine.warmup(block=True, timeout=TIMEOUT)
            assert engine.stats()["device"]["superbank_bytes"] > 0
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_warmup_empty_store(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="host"), store, store
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=TIMEOUT)  # no-op, no crash
            assert engine.query_sync(bs.new_query().token("x").build(), timeout=TIMEOUT) == []
        finally:
            engine.stop(timeout=TIMEOUT)


class TestIncrementalWarmup:
    """Scan programs compile on a RESERVED final matrix
    shape before the long pin pass; queries arriving mid-warmup run warm."""

    def _serving_store(self, tmp_path, blocks=6, rows=300, pad=0):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="host"), store, store
        )
        engine.start()
        filler = "x" * pad
        for b in range(blocks):
            engine.ingest_rows(
                [
                    {"b": b, "n": i, "w": f"blk{b}tok filler {i}", "p": filler}
                    for i in range(rows)
                ],
                timeout=TIMEOUT,
            )
            engine.flush(timeout=TIMEOUT)
        engine.stop(timeout=TIMEOUT)
        return store

    def test_timeline_and_shape_stability(self, tmp_path):
        store = self._serving_store(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=256 << 20
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            tl = engine.stats()["warmup"]
            # Programs ready no later than the full pin pass completes.
            assert tl["warm_ready_s"] <= tl["pins_s"] <= tl["total_s"]
            assert tl["reserved_chunks"] > 0
            cap_after_warm = engine._row_cache._bucket.cap
            # Reservation covered the dataset: no growth during pins.
            assert cap_after_warm == tl["reserved_chunks"]
            for b in range(6):
                res = engine.query_sync(
                    bs.new_query().token(f"blk{b}tok").build(), timeout=TIMEOUT
                )
                assert len(res) == 300
            assert engine._row_cache._bucket.cap == cap_after_warm
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_query_during_warmup_is_correct(self, tmp_path):
        store = self._serving_store(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=256 << 20
            ),
            store,
            store,
        )
        engine.start()
        try:
            fut = engine.warmup(block=False)
            # Race the warmup: results must be exact regardless of how much
            # of the pin/compile work has happened.
            res = engine.query_sync(bs.new_query().token("blk3tok").build(), timeout=60)
            assert len(res) == 300 and all(r["b"] == 3 for r in res)
            fut.result(timeout=120)
            res = engine.query_sync(bs.new_query().token("blk5tok").build(), timeout=60)
            assert len(res) == 300
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_stop_during_warmup_is_prompt_and_clean(self, tmp_path):
        """stop() racing an in-flight warmup (pin thread + concurrent scan
        thread + probe pass) must complete promptly and leave the store
        reusable by a fresh engine."""
        import time as _time

        store = self._serving_store(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=256 << 20
            ),
            store,
            store,
        )
        engine.start()
        engine.warmup(block=False)
        t0 = _time.monotonic()
        engine.stop(timeout=TIMEOUT)
        assert _time.monotonic() - t0 < TIMEOUT
        # The store must be intact for the next engine.
        engine2 = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=256 << 20
            ),
            store,
            store,
        )
        engine2.start()
        try:
            engine2.warmup(block=True, timeout=120)
            res = engine2.query_sync(
                bs.new_query().token("blk2tok").build(), timeout=60
            )
            assert len(res) == 300
        finally:
            engine2.stop(timeout=TIMEOUT)

    def test_beyond_budget_serving_evicts_in_place(self, tmp_path):
        """Dataset larger than row_cache_bytes: pins stop at the reservation,
        queries pin on demand with LRU evict-in-place, the matrix shape never
        changes, and every result stays exact (the xlscale steady state)."""
        # ~8 blocks x ~90 KB: the 300 KB budget reserves 512 chunks (256 KB)
        # and can hold only ~3 blocks at a time.
        store = self._serving_store(tmp_path, blocks=8, rows=400, pad=180)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device",
                row_cache_bytes=300 << 10,
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            rc = engine._row_cache
            cap0 = rc._bucket.cap
            assert rc._reserved_cap == cap0
            pinned0 = len(rc._blocks)
            assert pinned0 < 8  # budget can't hold everything
            # Sweep all blocks repeatedly: forces pin->evict->compact churn.
            for rep in range(2):
                for b in range(8):
                    res = engine.query_sync(
                        bs.new_query().token(f"blk{b}tok").build(), timeout=60
                    )
                    assert len(res) == 400 and all(r["b"] == b for r in res)
            assert rc._bucket.cap == cap0  # shape never moved
            st = rc.stats()
            assert st["device_bytes"] == cap0 * 512
        finally:
            engine.stop(timeout=TIMEOUT)


class TestWarmupAOTPrecompile:
    """The AOT passes (.lower().compile() with no launch lock held) run
    before the locked warm executions so mid-warmup queries never starve
    behind a multi-second compile holding the probe/scan launch lock."""

    def test_timeline_records_aot_passes(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=64 << 20
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            tl = engine.stats()["warmup"]
            assert tl.get("probe_aot_programs", 0) > 0, tl
            assert tl.get("scan_aot_programs", 0) > 0, tl
            # AOT must land no later than the (timeline-final) pin pass.
            assert tl["scan_aot_s"] <= tl["total_s"]
            got = engine.query_sync(
                bs.new_query().token("word11").build(), timeout=TIMEOUT
            )
            assert got == [{"n": 11, "w": "word11", "tag": "all"}]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_precompile_direct_calls_are_reentrant(self, tmp_path):
        """Direct calls return a positive count and are safe to repeat
        (second call hits jax's in-memory cache, still counts programs)."""
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=64 << 20
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            n1 = engine._device_backend.precompile_probe_programs()
            n2 = engine._device_backend.precompile_probe_programs()
            assert n1 > 0 and n2 == n1
            pinned = list(engine._row_cache._blocks.values())
            assert pinned
            s1 = engine._row_cache.precompile_scan_programs(pinned)
            s2 = engine._row_cache.precompile_scan_programs(pinned)
            assert s1 > 0 and s2 == s1
        finally:
            engine.stop(timeout=TIMEOUT)


class TestDuringWarmupServing:
    """Round-5 during-warmup SLO machinery: the scan-cold gate (queries
    never trigger an inline device-scan jit while warmup is still
    compiling) and the per-query bank promotion budget (queries never pay
    unbounded synchronous bank uploads)."""

    def test_scan_cold_gate_serves_exact_and_skips_device_scan(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", row_cache_bytes=64 << 20
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            launches_before = engine._row_cache.launches
            # Simulate mid-warmup (scan programs not ready): the gate must
            # route pinned blocks through the native disk path — exact
            # results, zero device scan launches.
            engine._warmup_active.set()
            engine._warmup_scan_ready.clear()
            got = engine.query_sync(
                bs.new_query().token("word77").build(), timeout=TIMEOUT
            )
            assert got == [{"n": 77, "w": "word77", "tag": "all"}]
            assert engine._row_cache.launches == launches_before
            timings = list(engine._query_timings)
            assert timings[-1].get("scan_cold_gate") is True
            # Gate lifts with the scan-ready event: device scanning resumes.
            engine._warmup_scan_ready.set()
            got = engine.query_sync(
                bs.new_query().token("word78").build(), timeout=TIMEOUT
            )
            assert got == [{"n": 78, "w": "word78", "tag": "all"}]
            assert engine._row_cache.launches > launches_before
        finally:
            engine._warmup_active.clear()
            engine.stop(timeout=TIMEOUT)

    def test_zero_promote_budget_query_exact_then_background_residency(
        self, tmp_path
    ):
        import time as _time

        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device", bank_promote_bytes_per_query=0
            ),
            store,
            store,
        )
        engine.start()
        try:
            # No warmup: every group is non-resident, and the zero budget
            # forbids inline promotion — host probing must serve the query
            # exactly while a background warm promotes the group.
            got = engine.query_sync(
                bs.new_query().token("word5").build(), timeout=TIMEOUT
            )
            assert got == [{"n": 5, "w": "word5", "tag": "all"}]
            deadline = _time.monotonic() + 20
            while _time.monotonic() < deadline:
                if engine._device_backend._by_file:
                    break
                _time.sleep(0.05)
            assert engine._device_backend._by_file  # background warm landed
            got = engine.query_sync(
                bs.new_query().token("word6").build(), timeout=TIMEOUT
            )
            assert got == [{"n": 6, "w": "word6", "tag": "all"}]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_default_budget_promotes_inline(self, tmp_path):
        store = _dataset(tmp_path)
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="device"), store, store
        )
        engine.start()
        try:
            got = engine.query_sync(
                bs.new_query().token("word9").build(), timeout=TIMEOUT
            )
            assert got == [{"n": 9, "w": "word9", "tag": "all"}]
            assert engine._device_backend._by_file  # promoted inline
            timings = list(engine._query_timings)
            assert timings[-1].get("bank_promote_bytes", 0) > 0
        finally:
            engine.stop(timeout=TIMEOUT)


class TestWarmupBankBudget:
    """Beyond-budget bank warmup (the >30 GB regime scaled down): warmup
    loads filter banks only up to bank_cache_bytes instead of LRU-thrashing
    every group through the cache; the un-warmed tail is served by the
    query path's sparse cold probes, so results stay exact."""

    def _multifile_store(self, tmp_path, files=5, rows=300):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(probe_backend="host"), store, store
        )
        engine.start()
        for f in range(files):
            engine.ingest_rows(
                [{"f": f, "n": i, "w": f"file{f}tok {i}"} for i in range(rows)],
                timeout=TIMEOUT,
            )
            engine.flush(timeout=TIMEOUT)
        engine.stop(timeout=TIMEOUT)
        return store

    def test_device_warmup_stops_at_bank_budget(self, tmp_path):
        store = self._multifile_store(tmp_path)
        total_bank_bytes = sum(
            g.size
            for mf in store.get_maybe_files_for_query(None)
            for g in mf.metadata.bank_groups
        )
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device",
                bank_cache_bytes=max(total_bank_bytes // 3, 1),
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            assert engine._warmup_timeline.get("bank_budget_hit") is True
            # No full-dataset thrash-load: warmup stopped loading groups at
            # the budget (only the compile rep(s) + pre-budget files are
            # resident), instead of pulling all 5 files through the LRU.
            # (total_bytes() is mesh-padded superbank capacity, so the
            # budget comparison itself is what capped the loads.)
            assert len(engine._device_backend._by_file) < 5
            for f in range(5):
                res = engine.query_sync(
                    bs.new_query().token(f"file{f}tok").build(), timeout=60
                )
                assert len(res) == 300 and all(r["f"] == f for r in res)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_probe_overflow_degrades_to_host_not_churn_error(self, tmp_path):
        """A single query whose bank groups exceed the device cache must
        degrade to host probing (budget admission + churn fallback in
        _probe_blocks), never raise 'segments kept churning'."""
        store = self._multifile_store(tmp_path, files=6, rows=200)
        total_bank_bytes = sum(
            g.size
            for mf in store.get_maybe_files_for_query(None)
            for g in mf.metadata.bank_groups
        )
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device",
                bank_cache_bytes=max(total_bank_bytes // 4, 1),
            ),
            store,
            store,
        )
        engine.start()
        try:
            for f in range(6):
                res = engine.query_sync(
                    bs.new_query().token(f"file{f}tok").build(), timeout=60
                )
                assert len(res) == 200 and all(r["f"] == f for r in res)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_device_warmup_stops_on_cumulative_load_despite_plateau(
        self, tmp_path
    ):
        """The xxlscale regression: superbank capacity (and so
        total_bytes()) PLATEAUS once LRU eviction recycles columns, so a
        budget check against total_bytes() alone never fires and warmup
        thrash-uploads every group in the dataset. The cumulative-loaded-bytes check must
        stop it even when total_bytes() reports under-budget forever."""
        store = self._multifile_store(tmp_path, files=6, rows=200)
        total_bank_bytes = sum(
            g.size
            for mf in store.get_maybe_files_for_query(None)
            for g in mf.metadata.bank_groups
        )
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="device",
                bank_cache_bytes=max(total_bank_bytes // 3, 1),
            ),
            store,
            store,
        )
        engine.start()
        try:
            # Simulate the eviction plateau: total_bytes() always reports
            # empty, so only the cumulative check can stop the loads.
            engine._device_backend.total_bytes = lambda: 0
            engine.warmup(block=True, timeout=120)
            assert engine._warmup_timeline.get("bank_budget_hit") is True
            assert len(engine._device_backend._by_file) < 6
            for f in range(6):
                res = engine.query_sync(
                    bs.new_query().token(f"file{f}tok").build(), timeout=60
                )
                assert len(res) == 200 and all(r["f"] == f for r in res)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_host_warmup_stops_at_bank_budget(self, tmp_path):
        store = self._multifile_store(tmp_path)
        total_bank_bytes = sum(
            g.size
            for mf in store.get_maybe_files_for_query(None)
            for g in mf.metadata.bank_groups
        )
        engine = bs.BloomSearchEngine(
            bs.BloomSearchEngineConfig(
                probe_backend="host",
                bank_cache_bytes=max(total_bank_bytes // 3, 1),
            ),
            store,
            store,
        )
        engine.start()
        try:
            engine.warmup(block=True, timeout=120)
            assert engine._warmup_timeline.get("bank_budget_hit") is True
            assert engine._host_bank_bytes <= engine.config.bank_cache_bytes
            for f in range(5):
                res = engine.query_sync(
                    bs.new_query().token(f"file{f}tok").build(), timeout=60
                )
                assert len(res) == 300 and all(r["f"] == f for r in res)
        finally:
            engine.stop(timeout=TIMEOUT)
