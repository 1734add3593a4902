"""Bloom math + hashing + host filter semantics.

Property coverage the device rebuild must guarantee (SURVEY.md §6 north star):
zero false negatives, empirical FPR ≈ configured p at estimated (m, k), and
OR-merge correctness. Also cross-checks native vs pure-Python murmur3/CRC32C.
"""

import math
import random

import numpy as np
import pytest

from bloomsearch_tpu import BloomFilter, estimate_parameters
from bloomsearch_tpu import native
from bloomsearch_tpu.bloom.hashing import (
    hash_keys_py,
    murmur3_x64_128,
    positions_for_hashes,
)
from bloomsearch_tpu.checksum import crc32c, crc32c_py


class TestEstimateParameters:
    def test_matches_classic_formula(self):
        # m = ceil(-n ln p / ln^2 2), k = ceil(m/n ln 2) — the bits-and-blooms
        # formulas the reference relies on (SURVEY.md §1).
        m, k = estimate_parameters(100_000, 0.001)
        assert m == math.ceil(-100_000 * math.log(0.001) / (math.log(2) ** 2))
        assert k == math.ceil(math.log(2) * m / 100_000)
        assert k == 10

    def test_small_n(self):
        m, k = estimate_parameters(1, 0.5)
        assert m >= 1 and k >= 1

    def test_invalid_p(self):
        with pytest.raises(ValueError):
            estimate_parameters(100, 0.0)
        with pytest.raises(ValueError):
            estimate_parameters(100, 1.0)


class TestMurmur3:
    def test_empty_input_seed_zero(self):
        assert murmur3_x64_128(b"") == (0, 0)

    def test_known_lengths_stable(self):
        # Hashes must be stable across processes/runs (files are persistent).
        h1, h2 = murmur3_x64_128(b"hello")
        assert (h1, h2) == murmur3_x64_128(b"hello")
        assert murmur3_x64_128(b"hello") != murmur3_x64_128(b"hellp")

    @pytest.mark.skipif(not native.available(), reason="native lib unavailable")
    def test_native_matches_python(self):
        rng = random.Random(42)
        keys = [
            bytes(rng.randrange(256) for _ in range(length))
            for length in list(range(0, 40)) + [63, 64, 65, 127, 128, 1000]
            for _ in range(2)
        ]
        expected = hash_keys_py(keys)
        actual = native.hash_batch(keys)
        np.testing.assert_array_equal(expected, actual)

    def test_positions_in_range(self):
        hashes = hash_keys_py([b"a", b"b", b"c"])
        pos = positions_for_hashes(hashes, k=10, m_bits=1000)
        assert pos.shape == (3, 10)
        assert (pos < 1000).all()


class TestCrc32c:
    def test_known_vector(self):
        # RFC 3720 iSCSI CRC32C test vector: 32 zero bytes -> 0x8A9136AA.
        assert crc32c_py(b"\x00" * 32) == 0x8A9136AA
        # "123456789" -> 0xE3069283.
        assert crc32c_py(b"123456789") == 0xE3069283

    @pytest.mark.skipif(not native.available(), reason="native lib unavailable")
    def test_native_matches_python(self):
        rng = random.Random(7)
        for length in [0, 1, 7, 8, 9, 63, 64, 100, 1000]:
            data = bytes(rng.randrange(256) for _ in range(length))
            assert native.crc32c(data) == crc32c_py(data)

    def test_dispatch(self):
        assert crc32c(b"123456789") == 0xE3069283


class TestBloomFilter:
    def test_zero_false_negatives(self):
        f = BloomFilter.new_with_estimates(1000, 0.01)
        keys = [f"key-{i}" for i in range(1000)]
        f.add_keys(keys)
        assert f.test_keys(keys).all()

    def test_empirical_fpr_near_configured(self):
        p = 0.01
        f = BloomFilter.new_with_estimates(2000, p)
        f.add_keys([f"present-{i}" for i in range(2000)])
        absent = [f"absent-{i}" for i in range(20000)]
        fpr = f.test_keys(absent).mean()
        # Accept [0, 3p]: classic bloom at estimated (m, k) should be ~p.
        assert fpr <= 3 * p, f"FPR {fpr} too high for configured {p}"

    def test_empty_filter_matches_nothing(self):
        f = BloomFilter.new_with_estimates(100, 0.01)
        assert not f.test("anything")

    def test_merge_is_union(self):
        a = BloomFilter.new_with_estimates(1000, 0.01)
        b = BloomFilter.new_with_estimates(1000, 0.01)
        a.add_keys(["x1", "x2"])
        b.add_keys(["y1", "y2"])
        a.merge(b)
        for key in ("x1", "x2", "y1", "y2"):
            assert a.test(key)

    def test_merge_requires_identical_params(self):
        a = BloomFilter.new_with_estimates(1000, 0.01)
        b = BloomFilter.new_with_estimates(2000, 0.01)
        with pytest.raises(ValueError):
            a.merge(b)

    def test_serialization_round_trip(self):
        f = BloomFilter.new_with_estimates(500, 0.001)
        f.add_keys([f"k{i}" for i in range(500)])
        g = BloomFilter.from_bytes(f.m_bits, f.k, f.to_bytes())
        assert f == g
        assert g.test("k0") and g.test("k499")

    def test_native_and_python_builds_identical(self):
        keys = [f"key-{i}" for i in range(200)]
        f_native = BloomFilter.new_with_estimates(200, 0.01)
        f_native.add_keys(keys)  # uses native when available

        f_py = BloomFilter.new_with_estimates(200, 0.01)
        hashes = hash_keys_py([k.encode() for k in keys])
        positions = positions_for_hashes(hashes, f_py.k, f_py.m_bits).ravel()
        word = (positions >> np.uint64(5)).astype(np.int64)
        bit = (positions & np.uint64(31)).astype(np.uint32)
        np.bitwise_or.at(f_py.words, word, np.uint32(1) << bit)
        assert f_native == f_py

    def test_copy_independent(self):
        f = BloomFilter.new_with_estimates(100, 0.01)
        f.add("a")
        g = f.copy()
        g.add("b")
        assert g.test("a") and g.test("b")
        # f unchanged by g's add (words arrays independent)
        assert not np.shares_memory(f.words, g.words)
