"""Device probe backend: superbanks, kernel parity, cache behavior.

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu with 8 virtual
devices); the XLA probe programs are validated against the host numpy probe,
which is the semantic spec.
"""

import numpy as np
import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu.bloom import BloomParams
from bloomsearch_tpu.bloom.bank import DeviceProbeBackend, Superbank
from bloomsearch_tpu.bloom.probe import (
    compile_bloom_terms,
    probe_bank_host,
    stack_filter_bank,
)
from bloomsearch_tpu.file_format import BloomFilters


def make_bank(params: BloomParams, per_block_keys: list[tuple[list, list, list]]):
    """Host bank uint32[3, W, B] from per-block (field, token, ft) key lists."""
    triples = []
    for field_keys, token_keys, ft_keys in per_block_keys:
        t = BloomFilters.from_params(params)
        t.field.add_keys(field_keys)
        t.token.add_keys(token_keys)
        t.field_token.add_keys(ft_keys)
        triples.append(t)
    return stack_filter_bank(triples)


PARAMS = BloomParams(1000, 0.01)
BLOCK_KEYS = [
    (["service"], ["error", "timeout"], ["service::payment"]),
    (["level"], ["info"], ["level::info"]),
    (["service", "level"], ["error"], ["service::auth"]),
]


def make_terms(*exprs):
    query = bs.new_query()
    for kind, *args in exprs:
        getattr(query, kind)(*args)
    q = query.build()
    return q.bloom, compile_bloom_terms(q.bloom)


class TestBackendParity:
    @staticmethod
    def to_bank2d(bank: np.ndarray, C: int = 128) -> np.ndarray:
        """Pad a [3, W, B] host bank into the probe's 2D layout [3W, C]."""
        _, W, B = bank.shape
        out = np.zeros((3 * W, C), dtype=np.uint32)
        out[:, :B] = bank.reshape(3 * W, B)
        return out

    @staticmethod
    def flat_probes(terms, W: int):
        word_idx, bit_idx = terms.positions_for(PARAMS.m_bits, PARAMS.k)
        flat_rows = (terms.ks_idx[:, None].astype(np.int32) * W + word_idx).reshape(-1)
        return flat_rows, bit_idx.reshape(-1)

    def test_xla_matches_host(self):
        import jax.numpy as jnp

        from bloomsearch_tpu.bloom.device_probe import probe_bank_xla

        bank = make_bank(PARAMS, BLOCK_KEYS)
        _, terms = make_terms(
            ("token", "error"), ("field", "level"), ("field_token", "service", "payment")
        )
        expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
        flat_rows, shifts = self.flat_probes(terms, bank.shape[1])
        actual = np.asarray(
            probe_bank_xla(
                jnp.asarray(self.to_bank2d(bank)),
                jnp.asarray(flat_rows),
                jnp.asarray(shifts),
                PARAMS.k,
            )
        )[:, : bank.shape[2]]
        np.testing.assert_array_equal(expected, actual)

    def test_pallas_multi_tile_grid_matches_host(self):
        """A bank many 128-column units wide, random bits: every program of
        the fused ladder (full bitmap, flat-AND reduce, CNF clauses) must
        equal the per-(term, probe) bit definition, padding terms included."""
        import jax.numpy as jnp

        from bloomsearch_tpu.bloom.device_probe import (
            probe_and_pack,
            probe_clauses_pack,
            probe_reduce_and_pack,
        )
        from bloomsearch_tpu.parallel import unpack_bitmap

        rng = np.random.default_rng(7)
        R, C, T, K = 16, 1024, 4, 4
        # Dense random bits AND-ed over K probes survive ~1/16 of columns.
        bank2d = rng.integers(0, 2**32, size=(R, C), dtype=np.uint32)
        flat_rows = rng.integers(0, R, size=T * K).astype(np.int32)
        shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
        want = np.ones((T, C), dtype=bool)
        for t in range(T):
            for j in range(K):
                p = t * K + j
                bits = (bank2d[flat_rows[p]] >> np.uint32(shifts[p])) & 1
                want[t] &= bits.astype(bool)
        args = (jnp.asarray(bank2d), jnp.asarray(flat_rows), jnp.asarray(shifts), T, K)

        got = unpack_bitmap(np.asarray(probe_and_pack(*args)), C)
        np.testing.assert_array_equal(got, want)

        mask = np.array([True, True, True, False])  # last term is padding
        got = unpack_bitmap(
            np.asarray(probe_reduce_and_pack(*args, jnp.asarray(mask))), C
        )
        np.testing.assert_array_equal(got[0], want[:3].all(axis=0))

        # (t0 OR t1) AND t2 for member 0; t3 alone for member 1.
        clause = np.zeros((16, T), np.float32)
        clause[0, [0, 1]] = 1
        clause[1, 2] = 1
        clause[2, 3] = 1
        member = np.zeros((16, 16), np.float32)
        member[0, [0, 1]] = 1
        member[1, 2] = 1
        got = unpack_bitmap(
            np.asarray(
                probe_clauses_pack(*args, jnp.asarray(clause), jnp.asarray(member))
            ),
            C,
        )
        np.testing.assert_array_equal(got[0], (want[0] | want[1]) & want[2])
        np.testing.assert_array_equal(got[1], want[3])
        assert got[2:].all(), "padding members (no clauses) survive everywhere"

    def test_pallas_interpret_matches_host(self):
        """Packed device probe of a real filter bank equals the host numpy
        probe; padded (zero) columns never match."""
        import jax.numpy as jnp

        from bloomsearch_tpu.bloom.device_probe import probe_and_pack
        from bloomsearch_tpu.parallel import unpack_bitmap

        bank = make_bank(PARAMS, BLOCK_KEYS)
        _, terms = make_terms(("token", "error"), ("field", "level"))
        T = len(terms)
        bank2d = self.to_bank2d(bank)
        flat_rows, shifts = self.flat_probes(terms, bank.shape[1])
        packed = probe_and_pack(
            jnp.asarray(bank2d), jnp.asarray(flat_rows), jnp.asarray(shifts), T, PARAMS.k
        )
        match = unpack_bitmap(np.asarray(packed), bank2d.shape[1])
        expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
        np.testing.assert_array_equal(expected, match[:, : bank.shape[2]])
        assert not match[:, bank.shape[2] :].any()


class TestSuperbank:
    def make_sb(self):
        import jax
        import jax.numpy as jnp

        return Superbank(PARAMS.m_bits, PARAMS.k, "classic", jnp, jax)

    def test_insert_and_grow(self):
        sb = self.make_sb()
        bank1 = make_bank(PARAMS, BLOCK_KEYS)
        start, n = sb.insert(b"k1", bank1)
        assert (start, n) == (0, 3)
        assert sb.capacity % 128 == 0
        old_cap = sb.capacity
        # Force growth past the current capacity.
        big = make_bank(PARAMS, [(["x"], ["y"], ["z"])] * 130)
        start2, n2 = sb.insert(b"k2", big)
        assert start2 == 3 and n2 == 130
        assert sb.capacity > old_cap
        # Original columns survive growth.
        host = np.asarray(sb.bank2d[: 3 * sb.num_words, :3])
        np.testing.assert_array_equal(host, bank1.reshape(3 * sb.num_words, 3))

    def test_staged_insert_matches_direct(self, monkeypatch):
        """Piecewise column staging (pow2 pieces + yield points) must
        publish bit-identical columns to the single-shot upload path."""
        from bloomsearch_tpu.bloom import bank as bank_mod

        # Force multi-piece staging at test sizes (default pieces are 8 MB).
        monkeypatch.setattr(bank_mod, "_STAGE_PIECE_BYTES", PARAMS.num_words * 3 * 4 * 2)
        sb_direct = self.make_sb()
        sb_staged = self.make_sb()
        big = make_bank(
            PARAMS, [([f"f{i}"], [f"t{i}"], [f"ft{i}"]) for i in range(11)]
        )
        sb_direct.insert(b"k", big)
        yields = []
        staged = sb_staged.stage(big, yield_to=lambda: yields.append(1) and False)
        # Width buckets to a max_piece multiple (one piece-program shape per
        # rows-family); the zero tail never joins a segment.
        assert staged.shape[0] == 3 * sb_staged.num_words
        assert staged.shape[1] >= 11 and staged.shape[1] % 2 == 0
        assert yields  # multi-piece: the gate was polled between pieces
        sb_staged.insert(b"k", big, staged=staged)
        np.testing.assert_array_equal(
            np.asarray(sb_direct.bank2d), np.asarray(sb_staged.bank2d)
        )

    def test_remove_and_compact(self):
        sb = self.make_sb()
        bank1 = make_bank(PARAMS, BLOCK_KEYS)
        bank2 = make_bank(PARAMS, [(["a"], ["b"], ["c"])])
        sb.insert(b"k1", bank1)
        sb.insert(b"k2", bank2)
        sb.remove(b"k1")
        sb.maybe_compact()  # dead (3) >= live (1): compacts
        assert sb.used == 1
        assert b"k2" in sb.segments and b"k1" not in sb.segments
        np.testing.assert_array_equal(
            np.asarray(sb.bank2d[: 3 * sb.num_words, :1]),
            bank2.reshape(3 * sb.num_words, 1),
        )


class TestDeviceProbeBackend:
    def test_probe_groups_and_residency(self):
        backend = DeviceProbeBackend()
        bank = make_bank(PARAMS, BLOCK_KEYS)
        loads = []

        def loader():
            loads.append(1)
            return bank

        mk = (PARAMS.m_bits, PARAMS.k, "classic")
        _, terms = make_terms(("token", "error"))
        out = backend.probe_groups([(b"file-1", 0, mk, loader)], terms)
        match = out[(b"file-1", 0)]
        assert match.shape == (1, 3)
        expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
        np.testing.assert_array_equal(match, expected)
        assert len(loads) == 1

        # Second probe: bank already resident, loader not called again.
        backend.probe_groups([(b"file-1", 0, mk, loader)], terms)
        assert len(loads) == 1

        # Invalidation drops residency; loader runs again.
        backend.invalidate(b"file-1")
        backend.probe_groups([(b"file-1", 0, mk, loader)], terms)
        assert len(loads) == 2

    def test_eviction_budget_ignores_dead_columns(self):
        """Dead (invalidated) columns are reclaimable by compaction: the
        byte budget must not evict LIVE warm segments to shed memory a
        compaction can free — and when live fits but the physical bank
        still exceeds the budget, compaction is forced immediately."""
        mk = (PARAMS.m_bits, PARAMS.k, "classic")
        mkeys = lambda tag: [([f"{tag}{i}"], [f"t{tag}{i}"], []) for i in range(100)]
        banks = {t: make_bank(PARAMS, mkeys(t)) for t in "abc"}
        loads = {t: 0 for t in "abc"}

        def loader_for(t):
            def load():
                loads[t] += 1
                return banks[t]
            return load

        # Capacity after 3 inserts of 100 cols doubles to 512 (rows=904):
        # total 904*512*4 = 1.85 MB > the 1.7 MB budget. Evicting LRU "a"
        # marks 100 columns dead: the dead-adjusted budget (1.48 MB) is
        # satisfied, so "b"/"c" must SURVIVE and the over-budget physical
        # bank force-compacts to 256 cols (0.93 MB). The old capacity-based
        # budget kept evicting ("a" freed nothing physically) and threw
        # away warm "b" too.
        _, terms = make_terms(("token", "ta0"))
        backend = DeviceProbeBackend(cache_bytes=1_700_000, mesh_devices=1)
        for t in "abc":
            backend.probe_groups([(t.encode(), 0, mk, loader_for(t))], terms)
        assert not backend.is_resident(mk, backend.segment_key(b"a", 0))
        # Re-probe the live segments: must be served resident, no reload.
        for t in "bc":
            backend.probe_groups([(t.encode(), 0, mk, loader_for(t))], terms)
        assert loads == {"a": 1, "b": 1, "c": 1}, loads
        assert backend.is_resident(mk, backend.segment_key(b"b", 0))
        assert backend.is_resident(mk, backend.segment_key(b"c", 0))
        sb = backend._superbanks[mk]
        assert sb.dead == 0, "over-budget dead columns must compact away"
        assert sb.capacity * sb.num_rows * 4 <= backend.cache_bytes

    def test_eviction_under_budget(self):
        # Superbank memory is capacity-based: eviction triggers when growth
        # pushes capacity past the budget. Two 128-column files at a budget of
        # ~1.5 banks: inserting the second grows to 256 cols, evicting the
        # first (LRU) and compacting back under budget.
        # mesh_devices=1: the column allocation unit is 128*mesh_size, so the
        # byte math here assumes single-device granularity (LRU mechanics are
        # mesh-independent).
        one_bank_bytes = 3 * PARAMS.num_words * 128 * 4
        backend = DeviceProbeBackend(cache_bytes=int(one_bank_bytes * 1.5), mesh_devices=1)
        bank = make_bank(PARAMS, [(["x"], ["y"], ["z"])] * 128)
        mk = (PARAMS.m_bits, PARAMS.k, "classic")
        _, terms = make_terms(("token", "error"))
        loads = {"a": 0, "b": 0}

        def loader_for(name):
            def load():
                loads[name] += 1
                return bank

            return load

        backend.probe_groups([(b"A", 0, mk, loader_for("a"))], terms)
        backend.probe_groups([(b"B", 0, mk, loader_for("b"))], terms)
        assert backend.total_bytes() <= int(one_bank_bytes * 1.5)
        backend.probe_groups([(b"A", 0, mk, loader_for("a"))], terms)
        assert loads["a"] == 2, "A should have been evicted and reloaded"


class TestWarmOnFlush:
    def test_flush_preloads_device_banks(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        config = bs.BloomSearchEngineConfig(
            row_data_compression="none", probe_backend="device"
        )
        engine = bs.BloomSearchEngine(config, store, store)
        engine.start()
        try:
            engine.ingest_rows([{"w": "warmed"}], timeout=10)
            engine.flush(timeout=10)
            # The freshly flushed file's bank is already resident.
            assert engine._device_backend.total_bytes() > 0
            pointer = store.get_maybe_files_for_query(None)[0].pointer
            seg_key = engine._device_backend.segment_key(pointer, 0)
            resident = any(
                seg_key in sb.segments
                for sb in engine._device_backend._superbanks.values()
            )
            assert resident, "flush should have warmed the superbank"
            rows = engine.query_sync(bs.new_query().token("warmed").build(), timeout=30)
            assert len(rows) == 1
        finally:
            engine.stop(timeout=10)


class TestEngineWithDeviceBackend:
    def test_end_to_end_device_probe(self, tmp_path):
        store = bs.FileSystemDataStore(str(tmp_path / "data"))
        config = bs.BloomSearchEngineConfig(
            row_data_compression="none", probe_backend="device"
        )
        engine = bs.BloomSearchEngine(config, store, store)
        assert engine._device_backend is not None
        engine.start()
        try:
            engine.ingest_rows(
                [
                    {"service": "payment", "msg": "connection timeout"},
                    {"service": "auth", "msg": "login ok"},
                ],
                timeout=10,
            )
            engine.flush(timeout=10)
            rows = engine.query_sync(bs.new_query().token("timeout").build(), timeout=30)
            assert len(rows) == 1 and rows[0]["service"] == "payment"
            rows = engine.query_sync(
                bs.new_query().field_token("service", "auth").build(), timeout=30
            )
            assert len(rows) == 1 and rows[0]["service"] == "auth"
            # Repeat query hits the resident superbank.
            rows = engine.query_sync(bs.new_query().token("timeout").build(), timeout=30)
            assert len(rows) == 1
        finally:
            engine.stop(timeout=10)


class TestCrossQueryBatching:
    def test_concurrent_probes_coalesce_into_fewer_launches(self):
        """N threads probing the same superbank must share launches (the
        windowless leader-drains-queue combiner) with exact per-query
        results."""
        import threading

        backend = DeviceProbeBackend(mesh_devices=1)
        # One resident bank with distinctive per-block keys.
        keys = [([f"fld{i}"], [f"tok{i}", "shared"], [f"fld{i}::tok{i}"]) for i in range(40)]
        bank = make_bank(PARAMS, keys)
        mk = (PARAMS.m_bits, PARAMS.k, "classic")
        backend.probe_groups([(b"F", 0, mk, lambda: bank)], make_terms(("token", "shared"))[1])
        launches_before = backend.launches

        # Slow down launches so concurrent requests pile up behind a leader.
        orig = backend._launch_combined

        def slow_launch(*args, **kwargs):
            import time as _t

            _t.sleep(0.05)
            return orig(*args, **kwargs)

        backend._launch_combined = slow_launch

        results = {}
        errors = []

        def one_query(qi):
            try:
                _, terms = make_terms(("token", f"tok{qi}"), ("token", "shared"))
                out = backend.probe_groups([(b"F", 0, mk, lambda: bank)], terms)
                results[qi] = out[(b"F", 0)]
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [threading.Thread(target=one_query, args=(qi,)) for qi in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        launches = backend.launches - launches_before
        assert backend.batched_requests >= 12
        assert launches < 12, f"no batching happened: {launches} launches"

        # Every query got ITS OWN exact slice.
        for qi, match in results.items():
            _, terms = make_terms(("token", f"tok{qi}"), ("token", "shared"))
            expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
            np.testing.assert_array_equal(match, expected, err_msg=f"query {qi}")

    def test_big_burst_respects_launch_caps_and_stays_exact(self):
        """A burst larger than the combiner caps splits into multiple
        capped launches (every combined shape stays inside the warmed
        program set) and every query still gets its exact slice."""
        import threading

        from bloomsearch_tpu.bloom.bank import (
            _PROBE_BATCH_MAX_MEMBERS,
            _PROBE_BATCH_MAX_TERMS,
        )

        backend = DeviceProbeBackend(mesh_devices=1)
        keys = [([f"fld{i}"], [f"tok{i}", "shared"], [f"fld{i}::tok{i}"]) for i in range(40)]
        bank = make_bank(PARAMS, keys)
        mk = (PARAMS.m_bits, PARAMS.k, "classic")
        backend.probe_groups([(b"F", 0, mk, lambda: bank)], make_terms(("token", "shared"))[1])

        batch_shapes = []
        orig = backend._launch_combined

        def recording_launch(bank2d, capacity, k, batch):
            import time as _t

            batch_shapes.append((len(batch), sum(r.T for r in batch)))
            _t.sleep(0.02)  # let requests pile up behind the leader
            return orig(bank2d, capacity, k, batch)

        backend._launch_combined = recording_launch
        results = {}
        errors = []

        def one_query(qi):
            try:
                _, terms = make_terms(("token", f"tok{qi}"), ("token", "shared"))
                out = backend.probe_groups([(b"F", 0, mk, lambda: bank)], terms)
                results[qi] = out[(b"F", 0)]
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [threading.Thread(target=one_query, args=(qi,)) for qi in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        for members, total_t in batch_shapes:
            assert members == 1 or (
                members <= _PROBE_BATCH_MAX_MEMBERS
                and total_t <= _PROBE_BATCH_MAX_TERMS
            ), batch_shapes
        for qi, match in results.items():
            _, terms = make_terms(("token", f"tok{qi}"), ("token", "shared"))
            expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
            np.testing.assert_array_equal(match, expected, err_msg=f"query {qi}")

    def test_mixed_reduce_and_plain_batch(self):
        import threading

        backend = DeviceProbeBackend(mesh_devices=1)
        keys = [([f"f{i}"], [f"t{i}", "all"], [f"f{i}::t{i}"]) for i in range(16)]
        bank = make_bank(PARAMS, keys)
        mk = (PARAMS.m_bits, PARAMS.k, "classic")
        backend.probe_groups([(b"F", 0, mk, lambda: bank)], make_terms(("token", "all"))[1])

        orig = backend._launch_combined

        def slow_launch(*args, **kwargs):
            import time as _t

            _t.sleep(0.05)
            return orig(*args, **kwargs)

        backend._launch_combined = slow_launch
        out = {}

        def reduced(qi):
            _, terms = make_terms(("token", "all"), ("token", f"t{qi}"))
            r = backend.probe_groups([(b"F", 0, mk, lambda: bank)], terms, reduce_and=True)
            out[("r", qi)] = r[(b"F", 0)]

        def plain(qi):
            _, terms = make_terms(("token", f"t{qi}"))
            r = backend.probe_groups([(b"F", 0, mk, lambda: bank)], terms)
            out[("p", qi)] = r[(b"F", 0)]

        threads = [threading.Thread(target=reduced, args=(i,)) for i in range(4)] + [
            threading.Thread(target=plain, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for qi in range(4):
            _, terms = make_terms(("token", "all"), ("token", f"t{qi}"))
            expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k).all(
                axis=0, keepdims=True
            )
            np.testing.assert_array_equal(out[("r", qi)], expected)
            _, terms = make_terms(("token", f"t{qi}"))
            expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
            np.testing.assert_array_equal(out[("p", qi)], expected)


class TestOversizedSoloRequests:
    """A single request above the launch caps splits / host-evaluates so
    every device launch stays inside the warmed shape set (Tp<=16, total
    clauses<=16) — an oversized one-off shape would pay a fresh jit on the
    first real query that produced it (shape-space discipline)."""

    MK = (PARAMS.m_bits, PARAMS.k, "classic")

    def _tracking_backend(self):
        backend = DeviceProbeBackend(mesh_devices=1)
        shapes: list[tuple[int, int]] = []
        orig = backend._launch_combined

        def tracking(bank2d, capacity, k, batch):
            shapes.append(
                (
                    sum(r.T for r in batch),
                    sum(
                        r.clause_mask.shape[0]
                        for r in batch
                        if r.clause_mask is not None
                    ),
                )
            )
            return orig(bank2d, capacity, k, batch)

        backend._launch_combined = tracking
        return backend, shapes

    def test_20_term_flat_and_splits_and_stays_exact(self):
        backend, shapes = self._tracking_backend()
        tokens = [f"t{i}" for i in range(20)]
        # Block 0 holds every token; blocks 1/2 each miss one.
        bank = make_bank(
            PARAMS,
            [([], tokens, []), ([], tokens[:19], []), ([], tokens[1:], [])],
        )
        _, terms = make_terms(*[("token", t) for t in tokens])
        out = backend.probe_groups(
            [(b"F", 0, self.MK, lambda: bank)], terms, reduce_and=True
        )
        expected = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k).all(
            axis=0, keepdims=True
        )
        np.testing.assert_array_equal(out[(b"F", 0)], expected)
        assert expected[0, 0]
        assert len(shapes) >= 2 and all(t <= 16 for t, _ in shapes)

    def test_wide_cnf_falls_back_to_host_eval(self):
        import itertools

        from bloomsearch_tpu.bloom.probe import (
            compile_cnf_clauses,
            evaluate_match_expression,
        )

        backend, shapes = self._tracking_backend()
        pool = [f"p{i}" for i in range(6)]
        bank = make_bank(
            PARAMS, [([], pool[:4], []), ([], pool[2:], []), ([], [], [])]
        )
        # 20 distinct 3-token OR clauses over 6 terms: T=6 <= 16 but C=20
        # exceeds the warmed Cp=16 — fusion must be skipped, not compiled.
        tree = bs.and_(
            *[
                bs.or_(*[bs.token(t) for t in combo])
                for combo in itertools.combinations(pool, 3)
            ]
        )
        q = bs.new_query().match(tree).build()
        terms = compile_bloom_terms(q.bloom)
        mask = compile_cnf_clauses(q.bloom.expression, terms)
        assert mask is not None and mask.shape[0] > 16
        out = backend.probe_groups(
            [(b"F", 0, self.MK, lambda: bank)], terms, clause_mask=mask
        )
        match = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
        expected = np.asarray(
            evaluate_match_expression(
                q.bloom.expression, terms, match, match.shape[1]
            )
        )[None, :]
        np.testing.assert_array_equal(out[(b"F", 0)], expected)
        assert all(c <= 16 for _, c in shapes)

    def test_oversized_clause_query_splits_and_honors_fusion_contract(self):
        from bloomsearch_tpu.bloom.probe import (
            compile_cnf_clauses,
            evaluate_match_expression,
        )

        backend, shapes = self._tracking_backend()
        # 17 AND-ed 2-token ORs -> 34 terms, 17 clauses: both caps exceeded.
        bank = make_bank(
            PARAMS,
            [
                ([], [f"a{i}" for i in range(17)], []),
                ([], [f"a{i}" for i in range(16)] + ["b16"], []),
                ([], ["a0"], []),
            ],
        )
        tree = bs.and_(
            *[bs.or_(bs.token(f"a{i}"), bs.token(f"b{i}")) for i in range(17)]
        )
        q = bs.new_query().match(tree).build()
        terms = compile_bloom_terms(q.bloom)
        mask = compile_cnf_clauses(q.bloom.expression, terms)
        assert mask is not None and len(terms) > 16
        out = backend.probe_groups(
            [(b"F", 0, self.MK, lambda: bank)], terms, clause_mask=mask
        )
        match = probe_bank_host(bank, terms, PARAMS.m_bits, PARAMS.k)
        expected = np.asarray(
            evaluate_match_expression(
                q.bloom.expression, terms, match, match.shape[1]
            )
        )[None, :]
        np.testing.assert_array_equal(out[(b"F", 0)], expected)
        assert expected[0, 0] and expected[0, 1]
        assert all(t <= 16 and c <= 16 for t, c in shapes)
