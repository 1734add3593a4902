"""Engine-integrated multi-chip probing over the virtual 8-device CPU mesh.

The device probe backend shards every superbank's block axis across the mesh
(bank.py Superbank(mesh=...)); an ordinary ``engine.query_sync`` then probes
all chips in one launch. These tests assert the bank is *demonstrably*
sharded (device placement) and results stay oracle-exact, including through
growth, tombstone-driven compaction, and the Triton-route scan kernel (Pallas
interpreter) inside shard_map.
"""

import jax
import numpy as np
import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu import BloomSearchEngine, BloomSearchEngineConfig, FileSystemDataStore

TIMEOUT = 15.0


def make_engine(tmp_path, **overrides):
    store = FileSystemDataStore(str(tmp_path / "data"))
    config = BloomSearchEngineConfig(
        row_data_compression="none", probe_backend="device", **overrides
    )
    engine = BloomSearchEngine(config, store, store)
    engine.start()
    return engine, store


def dataset(n_files=4, rows_per_file=40):
    files = []
    for f in range(n_files):
        files.append(
            [
                {"n": f * rows_per_file + i, "svc": f"svc{f}", "msg": f"w{f}_{i} common"}
                for i in range(rows_per_file)
            ]
        )
    return files


class TestEngineMeshProbe:
    def test_query_over_mesh_is_oracle_exact_and_sharded(self, tmp_path):
        assert len(jax.devices()) == 8
        engine, _ = make_engine(tmp_path)
        try:
            backend = engine._device_backend
            assert backend is not None and backend.mesh is not None
            assert backend.mesh.shape["blocks"] == 8

            files = dataset()
            all_rows = [r for f in files for r in f]
            for rows in files:
                engine.ingest_rows(rows, timeout=TIMEOUT)
                engine.flush(timeout=TIMEOUT)

            # Needle: exactly one row carries w2_7.
            got = engine.query_sync(bs.new_query().token("w2_7").build(), timeout=TIMEOUT)
            assert got == [r for r in all_rows if "w2_7" in r["msg"]]

            # Common token: every row.
            got = engine.query_sync(bs.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in got) == [r["n"] for r in all_rows]

            # AND/OR tree across keyspaces.
            q = bs.new_query().match(
                bs.or_(bs.field_token("svc", "svc1"), bs.token("w3_0"))
            ).build()
            got = sorted(r["n"] for r in engine.query_sync(q, timeout=TIMEOUT))
            expected = sorted(
                r["n"] for r in all_rows if r["svc"] == "svc1" or "w3_0 " in r["msg"] + " "
            )
            assert got == expected

            # The superbank must actually be sharded across all 8 devices.
            assert backend._superbanks, "device path not exercised"
            for sb in backend._superbanks.values():
                sharding = sb.bank2d.sharding
                assert len(sharding.device_set) == 8, sharding
                local = sb.bank2d.addressable_shards[0].data
                assert local.shape[1] == sb.capacity // 8
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_growth_and_compaction_stay_sharded_and_exact(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        try:
            backend = engine._device_backend
            # Many small flushes force superbank growth (capacity doubling).
            for f in range(6):
                engine.ingest_rows(
                    [{"n": f * 10 + i, "tag": f"t{f}"} for i in range(10)], timeout=TIMEOUT
                )
                engine.flush(timeout=TIMEOUT)
            before = engine.query_sync(bs.new_query().token("t4").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in before) == list(range(40, 50))

            # Merge replaces files -> tombstones -> segment removal/compaction.
            engine.merge()
            for sb in backend._superbanks.values():
                assert len(sb.bank2d.sharding.device_set) == 8

            after = engine.query_sync(bs.new_query().token("t4").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in after) == list(range(40, 50))
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_explicit_mesh_devices_partial(self, tmp_path):
        engine, _ = make_engine(tmp_path, mesh_devices=4)
        try:
            backend = engine._device_backend
            assert backend.mesh is not None and backend.mesh.shape["blocks"] == 4
            engine.ingest_rows([{"a": "hello world"}], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            got = engine.query_sync(bs.new_query().token("hello").build(), timeout=TIMEOUT)
            assert got == [{"a": "hello world"}]
            for sb in backend._superbanks.values():
                assert len(sb.bank2d.sharding.device_set) == 4
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_mesh_devices_one_disables_sharding(self, tmp_path):
        engine, _ = make_engine(tmp_path, mesh_devices=1)
        try:
            assert engine._device_backend.mesh is None
            engine.ingest_rows([{"a": "solo"}], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            got = engine.query_sync(bs.new_query().token("solo").build(), timeout=TIMEOUT)
            assert got == [{"a": "solo"}]
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_mesh_devices_too_many_raises(self, tmp_path):
        store = FileSystemDataStore(str(tmp_path / "data"))
        config = BloomSearchEngineConfig(
            row_data_compression="none", probe_backend="device", mesh_devices=64
        )
        with pytest.raises(RuntimeError):
            BloomSearchEngine(config, store, store)


class TestEngineMeshPallasInterpret:
    def test_full_query_through_pallas_interpret_shard_map(self, tmp_path, monkeypatch):
        """An ordinary engine query in serving mode on the 8-device mesh:
        sharded XLA probe, then the Triton-route scan kernel (Pallas
        interpreter on CPU) inside shard_map over the sharded stream — the
        combination a multi-GPU host runs."""
        import functools

        from bloomsearch_tpu import stream_scan

        monkeypatch.setattr(
            stream_scan, "scan_triton",
            functools.partial(stream_scan.scan_triton, interpret=True),
        )
        engine, _ = make_engine(
            tmp_path, row_cache_bytes=64 << 20, row_cache_async_pins=False
        )
        try:
            rc = engine._row_cache
            assert rc is not None and rc.mesh is not None
            rc.scan_impl = "triton"
            files = dataset(n_files=2, rows_per_file=20)
            for rows in files:
                engine.ingest_rows(rows, timeout=TIMEOUT)
                engine.flush(timeout=TIMEOUT)
            want = [r for f in files for r in f if "w1_3" in r["msg"]]
            q = bs.new_query().token("w1_3").build()
            assert engine.query_sync(q, timeout=TIMEOUT) == want
            launches = rc.launches
            # Pinned now: the repeat scans the sharded stream on-device.
            assert engine.query_sync(q, timeout=TIMEOUT) == want
            assert rc.launches > launches, "device scan not exercised"
            assert len(rc._bucket.matrix.sharding.device_set) == 8
        finally:
            engine.stop(timeout=TIMEOUT)


class TestShardMapPallasParity:
    def test_sharded_pallas_interpret_matches_host(self):
        """Every sharded probe program (full bitmap, fused flat-AND step
        with its psum'd survivor count, CNF clauses) equals the host probe
        over a bank split across 8 devices."""
        from bloomsearch_tpu.bloom import BloomParams
        from bloomsearch_tpu.bloom.probe import (
            compile_bloom_terms,
            probe_bank_host,
            stack_filter_bank,
        )
        from bloomsearch_tpu.file_format import BloomFilters
        from bloomsearch_tpu.parallel import (
            default_mesh,
            shard_bank,
            sharded_probe_packed,
            sharded_query_step,
            unpack_bitmap,
        )
        from bloomsearch_tpu.parallel.mesh import sharded_probe_clauses
        import jax.numpy as jnp

        params = BloomParams(300, 0.01)
        num_blocks = 24
        triples = []
        for i in range(num_blocks):
            t = BloomFilters.from_params(params)
            t.field.add_keys([f"field{i}"])
            t.token.add_keys([f"tok{i}", "shared"])
            t.field_token.add_keys([f"field{i}::tok{i}"])
            triples.append(t)
        bank = stack_filter_bank(triples)

        mesh = default_mesh()
        bank2d = shard_bank(mesh, bank.reshape(3 * params.num_words, num_blocks))
        q = bs.new_query().token("shared").field_token("field3", "tok3").build()
        terms = compile_bloom_terms(q.bloom)
        word_idx, bit_idx = terms.positions_for(params.m_bits, params.k)
        rows = jnp.asarray(
            (terms.ks_idx[:, None].astype(np.int32) * params.num_words + word_idx).reshape(-1)
        )
        shifts = jnp.asarray(bit_idx.reshape(-1))
        T = len(terms)
        expected = probe_bank_host(bank, terms, params.m_bits, params.k)

        packed = sharded_probe_packed(mesh, bank2d, rows, shifts, T, params.k)
        np.testing.assert_array_equal(
            unpack_bitmap(np.asarray(packed), num_blocks), expected
        )

        packed, total = sharded_query_step(
            mesh, bank2d, rows, shifts, jnp.ones(T, dtype=bool), T, params.k
        )
        survivors = unpack_bitmap(np.asarray(packed)[None, :], num_blocks)[0]
        np.testing.assert_array_equal(survivors, expected.all(axis=0))
        assert int(total) == int(expected.all(axis=0).sum())

        clause = np.zeros((16, T), np.float32)
        clause[0, :] = 1  # one OR clause over every term
        member = np.zeros((16, 16), np.float32)
        member[0, 0] = 1
        packed = sharded_probe_clauses(
            mesh, bank2d, rows, shifts, jnp.asarray(clause), jnp.asarray(member),
            T, params.k,
        )
        got = unpack_bitmap(np.asarray(packed), num_blocks)
        np.testing.assert_array_equal(got[0], expected.any(axis=0))


class TestFusedFlatAnd:
    def test_flat_and_reduces_on_device_and_stays_exact(self, tmp_path):
        engine, _ = make_engine(tmp_path)
        try:
            backend = engine._device_backend
            calls = []
            orig = backend.probe_groups

            def spy(requests, terms, reduce_and=False, clause_mask=None):
                calls.append(reduce_and)
                return orig(
                    requests, terms, reduce_and=reduce_and, clause_mask=clause_mask
                )

            backend.probe_groups = spy
            files = dataset(n_files=2, rows_per_file=15)
            for rows in files:
                engine.ingest_rows(rows, timeout=TIMEOUT)
                engine.flush(timeout=TIMEOUT)

            # Implicit-AND builder query: fused on-device reduction.
            q = bs.new_query().token("common").field_token("svc", "svc1").build()
            got = sorted(
                r["n"] for r in engine.query_sync(q, timeout=TIMEOUT)
            )
            assert got == [r["n"] for f in files for r in f if r["svc"] == "svc1"]
            assert calls and calls[-1] is True

            # OR tree: falls back to host expression evaluation.
            q = bs.new_query().match(bs.or_(bs.token("w0_1"), bs.token("w1_2"))).build()
            got = sorted(r["n"] for r in engine.query_sync(q, timeout=TIMEOUT))
            expected = sorted(
                r["n"] for f in files for r in f
                if "w0_1" in r["msg"].split() or "w1_2" in r["msg"].split()
            )
            assert got == expected
            assert calls[-1] is False
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_is_flat_and_detection(self):
        from bloomsearch_tpu.bloom.probe import is_flat_and_expression

        assert is_flat_and_expression(bs.token("x"))
        assert is_flat_and_expression(bs.and_(bs.token("x"), bs.field("f")))
        assert not is_flat_and_expression(bs.or_(bs.token("x"), bs.field("f")))
        assert not is_flat_and_expression(
            bs.and_(bs.token("x"), bs.or_(bs.field("f"), bs.token("y")))
        )
        assert not is_flat_and_expression(None)


def _mesh_zeros(mesh):
    from bloomsearch_tpu.parallel import mesh as mesh_mod

    return lambda: mesh_mod.sharded_zeros(mesh, 8, 512)


def _row_cache_dense_scan(mesh):
    import jax.numpy as jnp

    from bloomsearch_tpu.parallel import mesh as mesh_mod
    from bloomsearch_tpu.rowcache import MAX_NEEDLE, DeviceRowCache
    from bloomsearch_tpu.stream_scan import MAX_SCAN_NEEDLES

    rc = DeviceRowCache(1 << 20, mesh_devices=1 if mesh is None else mesh.size)
    matrix = mesh_mod.sharded_zeros_rows(mesh, 512 * (mesh.size if mesh else 1), 128, jnp.int32)
    needles = jnp.zeros((MAX_SCAN_NEEDLES, MAX_NEEDLE), jnp.int32)
    lens = jnp.ones((MAX_SCAN_NEEDLES,), jnp.int32)
    return lambda: rc._scan(matrix, needles, lens, impl="xla", n_real=1, max_words=2)


class TestMeshLaunchSerialization:
    @pytest.mark.parametrize(
        "program", [_mesh_zeros, _row_cache_dense_scan], ids=["mesh_program", "row_cache_scan"]
    )
    def test_mesh_programs_wait_for_the_launch_lock(self, program, monkeypatch):
        """Multi-device programs run under one process-wide lock (the devices
        must all enqueue them in the same order, or their collectives
        deadlock); single-device calls never take it. ``program(mesh)`` sets
        up and returns the launch under test."""
        import threading

        from bloomsearch_tpu.parallel import default_mesh, mesh as mesh_mod

        class Recording:
            def __init__(self):
                self.lock = threading.Lock()
                self.acquired = 0

            def __enter__(self):
                self.lock.acquire()
                self.acquired += 1

            def __exit__(self, *exc):
                self.lock.release()

        one, four = program(None), program(default_mesh(n_devices=4))
        rec = Recording()
        monkeypatch.setattr(mesh_mod, "MESH_LAUNCH_LOCK", rec)
        one()
        assert rec.acquired == 0, "a one-device launch took the mesh lock"
        out = four()
        assert rec.acquired == 1, "mesh launch bypassed the lock"
        assert not rec.lock.locked()
        assert len(out.sharding.device_set) == 4

    def test_concurrent_sharded_launches_stay_exact(self, tmp_path):
        """Probe, scan and pin launches racing from many threads on the
        8-device mesh (what warmup's passes beside queries do) all finish
        with exact answers."""
        import threading

        engine, _ = make_engine(tmp_path, row_cache_bytes=64 << 20)
        try:
            files = dataset(n_files=3, rows_per_file=30)
            for rows in files:
                engine.ingest_rows(rows, timeout=TIMEOUT)
                engine.flush(timeout=TIMEOUT)
            want = {
                f"w{f}_{i}": [r for rs in files for r in rs if f"w{f}_{i} " in r["msg"] + " "]
                for f in range(3) for i in (1, 7)
            }
            errors = []

            def worker(tok):
                try:
                    for _ in range(3):
                        got = engine.query_sync(bs.new_query().token(tok).build(), timeout=60)
                        assert got == want[tok], (tok, got)
                except BaseException as exc:  # collected for the main thread
                    errors.append(exc)

            threads = [threading.Thread(target=worker, args=(tok,)) for tok in want]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
        finally:
            engine.stop(timeout=TIMEOUT)
