"""Serialized-rows ingest fast lane: parity with dict ingest + guards."""

import json

import numpy as np
import pytest

import bloomsearch_tpu as bs

TIMEOUT = 10.0


def make_engine(tmp_path, name="data", **overrides):
    store = bs.FileSystemDataStore(str(tmp_path / name))
    config = bs.BloomSearchEngineConfig(
        row_data_compression="none", probe_backend="host", **overrides
    )
    engine = bs.BloomSearchEngine(config, store, store)
    engine.start()
    return engine, store


ROWS = [
    {"svc": "api", "msg": "Request 1 DONE", "n": 1},
    {"svc": "db", "msg": "slow query 42ms", "n": 2},
    {"uni": "héllo unicode row"},
]


class TestSerializedIngest:
    def test_round_trip_and_query(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        try:
            payloads = [json.dumps(r, separators=(",", ":")).encode() for r in ROWS]
            engine.ingest_serialized(payloads, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            rows = engine.query_sync(bs.new_query().token("done").build(), timeout=TIMEOUT)
            assert len(rows) == 1 and rows[0]["n"] == 1
            rows = engine.query_sync(bs.new_query().token("héllo").build(), timeout=TIMEOUT)
            assert len(rows) == 1 and "uni" in rows[0]
            assert len(engine.query_sync(None, timeout=TIMEOUT)) == 3
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_filters_match_dict_ingest(self, tmp_path):
        payloads = [json.dumps(r, separators=(",", ":")).encode() for r in ROWS]

        e1, s1 = make_engine(tmp_path, "ser")
        e1.ingest_serialized(payloads, timeout=TIMEOUT)
        e1.flush(timeout=TIMEOUT)
        e1.stop(timeout=TIMEOUT)

        e2, s2 = make_engine(tmp_path, "dict")
        e2.ingest_rows(list(ROWS), timeout=TIMEOUT)
        e2.flush(timeout=TIMEOUT)
        e2.stop(timeout=TIMEOUT)

        m1 = s1.get_maybe_files_for_query(None)[0].metadata
        m2 = s2.get_maybe_files_for_query(None)[0].metadata
        assert m1.bloom_filters == m2.bloom_filters
        # Row payloads identical too.
        from bloomsearch_tpu.file_format import read_block_rows_compressed

        with s1.open_file(s1.get_maybe_files_for_query(None)[0].pointer) as fh:
            d1 = read_block_rows_compressed(fh, m1.data_blocks[0])
        with s2.open_file(s2.get_maybe_files_for_query(None)[0].pointer) as fh:
            d2 = read_block_rows_compressed(fh, m2.data_blocks[0])
        assert d1 == d2

    def test_non_canonical_number_spelling_still_found(self, tmp_path):
        """Verbatim bytes '1e5' index token '100000' (go_like_str of the
        parsed float): the candidate scan must NOT prune the row for the
        needle's absence — verbatim blocks are marked non-canonical and
        numeric needles can't disqualify them (the old path silently lost
        the row before exact verification: a false negative)."""
        engine, store = make_engine(tmp_path)
        try:
            engine.ingest_serialized(
                [b'{"a":1e5,"tag":"zz"}', b'{"a":1.5e2}', b'{"b":"word"}'],
                timeout=TIMEOUT,
            )
            engine.flush(timeout=TIMEOUT)
            for token, expect in (("100000", 1), ("150", 1), ("word", 1)):
                rows = engine.query_sync(
                    bs.new_query().token(token).build(), timeout=TIMEOUT
                )
                assert len(rows) == expect, (token, rows)
            rows = engine.query_sync(
                bs.new_query().field_token("a", "100000").build(), timeout=TIMEOUT
            )
            assert len(rows) == 1 and rows[0]["tag"] == "zz"
            # The block is marked non-canonical in metadata.
            blk = store.get_maybe_files_for_query(None)[0].metadata.data_blocks[0]
            assert blk.rows_canonical is False
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_dict_ingest_marks_blocks_canonical(self, tmp_path):
        engine, store = make_engine(tmp_path)
        try:
            engine.ingest_rows([{"a": 1e5, "tag": "zz"}], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            blk = store.get_maybe_files_for_query(None)[0].metadata.data_blocks[0]
            assert blk.rows_canonical is True
            # Canonical spelling: numeric-token queries keep working (and
            # keep pruning).
            rows = engine.query_sync(
                bs.new_query().token("100000").build(), timeout=TIMEOUT
            )
            assert len(rows) == 1
            # Merge of canonical+verbatim blocks must NOT claim canonical.
            engine.ingest_serialized([b'{"x":2e3}'], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            engine.merge()
            blocks = [
                b
                for mf in store.get_maybe_files_for_query(None)
                for b in mf.metadata.data_blocks
            ]
            assert blocks and all(b.rows_canonical is False for b in blocks)
            rows = engine.query_sync(
                bs.new_query().token("2000").build(), timeout=TIMEOUT
            )
            assert len(rows) == 1
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_trailing_garbage_rejected_like_json_loads(self, tmp_path):
        """json.loads (the spec) raises 'Extra data' for concatenated
        objects; the native fast lane must not silently index only the
        first object — both lanes reject the ingest."""
        from concurrent.futures import Future

        engine, _ = make_engine(tmp_path)
        try:
            done: Future = Future()
            engine.ingest_serialized([b'{"a":1}{"b":2}'], done=done, timeout=TIMEOUT)
            with pytest.raises(Exception, match="Extra data"):
                done.result(timeout=TIMEOUT)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_partition_func_requires_explicit_partition_id(self, tmp_path):
        engine, store = make_engine(tmp_path, partition_func=lambda r: r["p"])
        try:
            with pytest.raises(bs.InvalidConfigError):
                engine.ingest_serialized([b'{"p":"x"}'])
            # Explicit routing works and keeps partition pruning intact.
            engine.ingest_serialized([b'{"p":"x","n":1}'], partition_id="x")
            engine.ingest_serialized([b'{"p":"y","n":2}'], partition_id="y")
            engine.flush(timeout=TIMEOUT)
            blocks = [
                b
                for mf in store.get_maybe_files_for_query(None)
                for b in mf.metadata.data_blocks
            ]
            assert sorted(b.partition_id for b in blocks) == ["x", "y"]
            q = (
                bs.new_query()
                .match_prefilter(bs.partition(bs.partition_equals("y")))
                .build()
            )
            rows = engine.query_sync(q, timeout=TIMEOUT)
            assert [r["n"] for r in rows] == [2]
        finally:
            engine.stop(timeout=TIMEOUT)


class TestSerializedMinMax:
    """Fast-lane minmax via byte-level extraction."""

    def _metadata(self, store):
        files = store.get_maybe_files_for_query(None)
        return [b for mf in files for b in mf.metadata.data_blocks]

    def test_minmax_parity_with_dict_lane(self, tmp_path):
        rows = [
            {"ts": 100, "v": 1},
            {"ts": -7, "v": 2},
            {"ts": 3.7, "v": 3},          # float: floor/ceil widen
            {"ts": "not numeric", "v": 4},
            {"ts": True, "v": 5},          # bool is NOT numeric
            {"v": 6},                      # absent
            {"ts": None, "v": 7},
            {"ts": 10**25, "v": 8},        # clamps to int64 max
            {"ts": -2.5e18, "v": 9},
            {"ts": 1e309 if False else 250, "v": 10},
            {"uni": "héllo", "ts": 55},   # unicode elsewhere in the row
        ]
        payloads = [json.dumps(r, separators=(",", ":")).encode() for r in rows]

        e1, s1 = make_engine(tmp_path, "ser", min_max_indexes=["ts"])
        e1.ingest_serialized(payloads, timeout=TIMEOUT)
        e1.flush(timeout=TIMEOUT)
        e1.stop(timeout=TIMEOUT)

        e2, s2 = make_engine(tmp_path, "dict", min_max_indexes=["ts"])
        e2.ingest_rows(rows, timeout=TIMEOUT)
        e2.flush(timeout=TIMEOUT)
        e2.stop(timeout=TIMEOUT)

        b1 = self._metadata(s1)
        b2 = self._metadata(s2)
        assert len(b1) == len(b2) == 1
        assert b1[0].min_max_indexes == b2[0].min_max_indexes
        assert b1[0].min_max_indexes["ts"].min == -2500000000000000000
        assert b1[0].min_max_indexes["ts"].max == 2**63 - 1

    def test_minmax_parity_no_native(self, tmp_path, monkeypatch):
        monkeypatch.setenv("BLOOMSEARCH_TPU_NO_NATIVE", "1")
        rows = [{"ts": 5}, {"ts": 9.1}, {"ts": "x"}]
        payloads = [json.dumps(r, separators=(",", ":")).encode() for r in rows]
        engine, store = make_engine(tmp_path, min_max_indexes=["ts"])
        try:
            engine.ingest_serialized(payloads, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            idx = self._metadata(store)[0].min_max_indexes["ts"]
            assert (idx.min, idx.max) == (5, 10)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_prefilter_prunes_through_fast_lane(self, tmp_path):
        engine, store = make_engine(tmp_path, min_max_indexes=["ts"])
        try:
            engine.ingest_serialized(
                [json.dumps({"ts": i, "n": i}).encode() for i in range(10)],
                timeout=TIMEOUT,
            )
            engine.flush(timeout=TIMEOUT)
            engine.ingest_serialized(
                [json.dumps({"ts": 1000 + i, "n": 1000 + i}).encode() for i in range(10)],
                timeout=TIMEOUT,
            )
            engine.flush(timeout=TIMEOUT)
            q = (
                bs.new_query()
                .match_prefilter(bs.min_max("ts", bs.numeric_greater_than(500)))
                .build()
            )
            rows = engine.query_sync(q, timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == list(range(1000, 1010))
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_extractor_oracle_fuzz(self):
        """bs_extract_minmax agrees with the Python spec on tricky values."""
        import numpy as np

        from bloomsearch_tpu import native
        from bloomsearch_tpu.minmax import convert_to_min_max_int64

        if not native.available():
            pytest.skip("native library unavailable")

        cases = [
            b'{"ts":1}',
            b'{"ts":-1}',
            b'{"ts":0}',
            b'{"ts":-0}',
            b'{"ts":1.5}',
            b'{"ts":-1.5}',
            b'{"ts":2.0}',
            b'{"ts":1e3}',
            b'{"ts":1.7976931348623157e308}',
            b'{"ts":1e309}',                      # inf -> no value
            b'{"ts":123456789012345678901234567}',  # clamp
            b'{"ts":-123456789012345678901234567}',
            b'{"ts":9223372036854775807}',
            b'{"ts":-9223372036854775808}',
            b'{"ts":9223372036854775808}',
            b'{"ts":true}',
            b'{"ts":null}',
            b'{"ts":"55"}',
            b'{"ts":[1,2]}',
            b'{"ts":{"a":1}}',
            b'{"other":1}',
            b'{"ts":1,"ts":2}',                  # last dup wins
            b'{"ts":2,"ts":"x"}',
            b'{"a":{"ts":99},"ts":3}',           # nested ts ignored
            b'{"msg":"ts","ts":4}',              # key-looking string value
            b'{"msg":"{\\"ts\\":7}","ts":5}',     # embedded object in string
            b'{"\\u0074s":6}',                   # escaped key == ts
            b'{"ts":0.1}',
            b'{"ts":-0.0}',
            b'{"ts":3e-2}',
            b'{"ts":007}',                        # invalid JSON: fallback
            b'{"ts":+5}',                         # invalid JSON: fallback
            b'[1,2,3]',                           # non-object row
        ]
        lengths = np.fromiter((len(c) for c in cases), dtype=np.int64)
        offsets = np.zeros(len(cases), dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        res = native.extract_minmax(b"".join(cases), offsets, lengths, "ts")
        assert res is not None
        lo, hi, status = res
        for i, raw in enumerate(cases):
            try:
                parsed = json.loads(raw)
            except ValueError:
                parsed = None
            expected = None
            if isinstance(parsed, dict) and "ts" in parsed:
                expected = convert_to_min_max_int64(parsed["ts"])
            if status[i] == 2:
                # Fallback must only trigger where Python itself struggles
                # or content is genuinely outside the fast path; always OK.
                continue
            if expected is None:
                assert status[i] == 0, (i, raw, lo[i], hi[i])
            else:
                assert status[i] == 1, (i, raw)
                assert (lo[i], hi[i]) == expected, (i, raw)

    def test_extractor_random_fuzz(self):
        import random

        import numpy as np

        from bloomsearch_tpu import native
        from bloomsearch_tpu.minmax import convert_to_min_max_int64

        if not native.available():
            pytest.skip("native library unavailable")
        rng = random.Random(0x4EED)
        rows = []
        for _ in range(500):
            row = {}
            if rng.random() < 0.9:
                kind = rng.randrange(6)
                if kind == 0:
                    row["ts"] = rng.randrange(-(2**70), 2**70)
                elif kind == 1:
                    row["ts"] = rng.uniform(-1e19, 1e19)
                elif kind == 2:
                    row["ts"] = rng.choice([None, True, False, "str", [1], {"a": 1}])
                elif kind == 3:
                    row["ts"] = rng.uniform(-5, 5)
                elif kind == 4:
                    row["ts"] = rng.randrange(-100, 100)
                else:
                    row["ts"] = rng.choice([0.0, -0.0, 1e-300, 2.0**52])
            for j in range(rng.randrange(4)):
                row[f"k{j}"] = rng.choice([1, "x", {"ts": 9}, [3, "ts"]])
            rows.append(json.dumps(row, separators=(",", ":")).encode())
        lengths = np.fromiter((len(c) for c in rows), dtype=np.int64)
        offsets = np.zeros(len(rows), dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        res = native.extract_minmax(b"".join(rows), offsets, lengths, "ts")
        assert res is not None
        lo, hi, status = res
        for i, raw in enumerate(rows):
            parsed = json.loads(raw)
            expected = (
                convert_to_min_max_int64(parsed["ts"]) if "ts" in parsed else None
            )
            if status[i] == 2:
                continue  # fallback is always safe
            if expected is None:
                assert status[i] == 0, (i, raw)
            else:
                assert status[i] == 1, (i, raw)
                assert (lo[i], hi[i]) == expected, (i, raw, lo[i], hi[i], expected)


class TestRegexLiteralNumericSubstring:
    def test_regex_literal_substring_of_number_no_false_negative(self, tmp_path):
        """A regex mandatory literal like 'e+25' is a SUBSTRING of the
        canonical spelling '1.5e+25' but absent from verbatim bytes '15e24';
        the scan must not prune the verbatim block (round-4 review fix:
        _numeric_unsafe widened past float()-parseable)."""
        store = bs.FileSystemDataStore(str(tmp_path))
        engine = bs.BloomSearchEngine(bs.BloomSearchEngineConfig(), store, store)
        engine.start()
        try:
            engine.ingest_serialized(
                [b'{"v":15e24,"tag":"target"}', b'{"v":1,"tag":"other"}'],
                timeout=TIMEOUT,
            )
            engine.flush(timeout=TIMEOUT)
            q = bs.new_query().field_regex("v", r"e\+25$").build()
            rows = engine.query_sync(q, timeout=TIMEOUT)
            assert len(rows) == 1 and rows[0]["tag"] == "target", rows
        finally:
            engine.stop(timeout=TIMEOUT)
