"""Smoke test of the engine's device path on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py             # phases 0-2 on one card
    python chip_smoke.py --cards 4   # phase 3 alone: the engine on a 4-card mesh

Phases:

0. Environment: the card (nvidia-smi), JAX, the compile cache, the native
   library and the codecs. Fails unless JAX's platform is "gpu" and the
   native library built.
1. Kernels at real widths: every probe program at the benchmark bank shape
   against the host numpy probe, and both stream scans (the Triton kernel
   and the plain-jnp SWAR scan) against a numpy byte search; then their
   timings.
2. The engine's main path at the reference benchmark's size (perf's
   refscale dataset, 1,600 MB, snappy, seed 0): warmup, needle / CNF tree /
   regex / broad queries, every answer compared as a multiset of rows with
   a host-only engine over the same store; the device must have done the
   work (launch counters, placement, zero failed precompiles).
3. (--cards 4) Phase 2's engine path with the banks and the stream sharded
   over 4 GPUs, compared with a one-card engine and the host engine.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failure
exits non-zero without printing it. Everything runs in this one process:
JAX reserves most of a card's memory at start-up, so a second process
would fail for want of it.
"""

from __future__ import annotations

import argparse
import collections
import faulthandler
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REFSCALE_MB = 1600  # bench.py REFSCALE_TARGET_MB: the reference benchmark's size
REFSCALE_CHUNKS = 3_598_848  # refscale's reserved stream chunks (1.84 GB)
SCAN_PARITY_CHUNKS = 262_144
PROBE_BLOCKS = 32_768  # bench.py's kernel bank: 32,768 blocks (1.77 GB)
SPARSE_CHUNKS = 65_536  # a sparse scan launch: 4 segments of 16,384 chunks
PLATFORM = "gpu"

sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()!r}")
    return r.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 0


def phase0(cards: int) -> str:
    import jax

    import bloomsearch_tpu  # noqa: F401  (fails outside a checkout)
    from bloomsearch_tpu import native, route
    from bloomsearch_tpu.compression import (
        COMPRESSION_SNAPPY,
        COMPRESSION_ZSTD,
        compression_available,
    )

    cache = route.enable_compile_cache()  # before the first compile
    devices = jax.devices()
    platform = devices[0].platform
    log(f"[phase0] jax {jax.__version__} devices {devices}")
    check(platform == PLATFORM, f"JAX platform is {platform!r}, not {PLATFORM!r}")
    check(len(devices) >= cards, f"{cards} cards asked, {len(devices)} visible")
    smi = gpu_line()
    log(f"[phase0] nvidia-smi: {smi}")
    log(f"[phase0] compile cache: {cache}")
    built = native.available()
    log(f"[phase0] native library built: {built} (zstd decoder: {built and native.has_zstd()})")
    check(built, "native library did not build")
    mods = {}
    for mod in ("zstandard", "regex"):
        try:
            __import__(mod)
            mods[mod] = True
        except ImportError:
            mods[mod] = False
    log(
        f"[phase0] codecs: snappy={compression_available(COMPRESSION_SNAPPY)} "
        f"zstd={compression_available(COMPRESSION_ZSTD)}; optional modules {mods}"
    )
    log(f"[phase0] scan implementation on this platform: {route.scan_impl(platform)}")
    return smi


# ---------------------------------------------------------------- phase 1


def chained_launch_us(fn, bank, T, K, n_small=16, n_large=256) -> float:
    """Per-launch device time of ``fn(bank, rows, shifts)``: the slope between
    two lax.scan chains of distinct probe batches, serialized through the
    carry, so host dispatch drops out."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    R = bank.shape[0]

    @jax.jit
    def chain(bank, frs, shs):
        def body(tot, fs):
            fr, sh = fs
            fr, _ = jax.lax.optimization_barrier((fr, tot))
            out = fn(bank, fr, sh)
            return tot + out[0, 0] + out[-1, -1], ()

        tot, _ = jax.lax.scan(body, jnp.zeros((), jnp.uint32), (frs, shs))
        return tot

    def best(n: int) -> float:
        frs = jnp.asarray(rng.integers(0, R, size=(n, T * K)).astype(np.int32))
        shs = jnp.asarray(rng.integers(0, 32, size=(n, T * K)).astype(np.int32))
        chain(bank, frs, shs).block_until_ready()
        out = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            chain(bank, frs, shs).block_until_ready()
            out = min(out, time.perf_counter() - t0)
        return out

    return (best(n_large) - best(n_small)) / (n_large - n_small) * 1e6


def phase1_probe() -> None:
    import jax
    import jax.numpy as jnp

    import bloomsearch_tpu as bs
    from bloomsearch_tpu.bloom import BloomParams
    from bloomsearch_tpu.bloom.device_probe import (
        probe_and_pack,
        probe_clauses_pack,
        probe_reduce_and_pack,
    )
    from bloomsearch_tpu.bloom.probe import compile_bloom_terms, probe_bank_host
    from bloomsearch_tpu.parallel.mesh import unpack_bitmap

    # The benchmark bank: block blooms at the reference defaults (10k rows,
    # 0.1% FPR: m=143,776 bits, k=10) over 32,768 blocks (1.77 GB). Bits
    # are set with probability 3/4, so each term matches ~5.6% of blocks.
    params = BloomParams(10_000, 0.001)
    W, K, B = params.num_words, params.k, PROBE_BLOCKS
    rng = np.random.default_rng(0)
    host = rng.integers(0, 2**32, size=(3, W, B), dtype=np.uint32)
    host |= rng.integers(0, 2**32, size=(3, W, B), dtype=np.uint32)
    bank = jax.device_put(host.reshape(3 * W, B))
    for T in (1, 4, 16):
        q = bs.new_query()
        for i in range(T):
            q.token(f"term{i}")
        terms = compile_bloom_terms(q.build().bloom)
        check(len(terms) == T, f"compiled {len(terms)} terms, wanted {T}")
        word_idx, bit_idx = terms.positions_for(params.m_bits, K)
        rows = jnp.asarray(
            (terms.ks_idx[:, None].astype(np.int32) * W + word_idx).reshape(-1)
        )
        shifts = jnp.asarray(bit_idx.reshape(-1).astype(np.int32))
        want = probe_bank_host(host, terms, params.m_bits, K)

        got = unpack_bitmap(np.asarray(probe_and_pack(bank, rows, shifts, T, K)), B)
        check(np.array_equal(got, want), f"probe_and_pack T={T} != host probe")
        mask = jnp.ones((T,), bool)
        got = unpack_bitmap(
            np.asarray(probe_reduce_and_pack(bank, rows, shifts, T, K, mask)), B
        )[0]
        check(np.array_equal(got, want.all(axis=0)), f"probe_reduce_and_pack T={T}")
        clause = np.zeros((16, T), np.float32)
        clause[0] = 1  # one OR clause over every term
        member = np.zeros((16, 16), np.float32)
        member[0, 0] = 1
        clause, member = jnp.asarray(clause), jnp.asarray(member)
        got = unpack_bitmap(
            np.asarray(probe_clauses_pack(bank, rows, shifts, T, K, clause, member)), B
        )[0]
        check(np.array_equal(got, want.any(axis=0)), f"probe_clauses_pack T={T}")
        log(
            f"[phase1] probe T={T} C={B}: all 3 programs == host probe "
            f"({int(want.any(axis=0).sum())} blocks match some term)"
        )
        t_red = chained_launch_us(
            lambda b, r, s: probe_reduce_and_pack(b, r, s, T, K, mask), bank, T, K
        )
        t_cls = chained_launch_us(
            lambda b, r, s: probe_clauses_pack(b, r, s, T, K, clause, member), bank, T, K
        )
        t_full = chained_launch_us(lambda b, r, s: probe_and_pack(b, r, s, T, K), bank, T, K)
        log(
            f"[phase1] probe timing T={T} C={B} (XLA, per launch): "
            f"reduce {t_red:.2f} us, clauses {t_cls:.2f} us, full bitmap {t_full:.2f} us; "
            f"bytes needed {T * K * B * 4 / 1e6:.2f} MB"
        )
    bank.delete()
    del host


def byte_oracle(rows: np.ndarray, needle: bytes, valid: int) -> np.ndarray:
    """bool[G]: chunk g holds ``needle`` at some start byte < ``valid``."""
    nd = np.frombuffer(needle, np.uint8)
    g, s = np.nonzero(rows[:, :valid] == nd[0])
    ok = np.ones(g.size, dtype=bool)
    for j in range(1, nd.size):
        ok &= rows[g, s + j] == nd[j]
    out = np.zeros(rows.shape[0], dtype=bool)
    out[g[ok]] = True
    return out


def scan_batches(impl, rows32, needles, valid_words) -> np.ndarray:
    """Scan like the row cache: length-sorted launches of up to
    MAX_SCAN_NEEDLES needles at the longest needle's word bucket."""
    import jax.numpy as jnp

    from bloomsearch_tpu.rowcache import MAX_NEEDLE
    from bloomsearch_tpu.stream_scan import MAX_SCAN_NEEDLES, scan_stream, scan_word_bucket

    order = sorted(range(len(needles)), key=lambda i: len(needles[i]))
    hits = np.zeros((len(needles), rows32.shape[0]), dtype=bool)
    for base in range(0, len(order), MAX_SCAN_NEEDLES):
        part = order[base : base + MAX_SCAN_NEEDLES]
        padded = np.zeros((MAX_SCAN_NEEDLES, MAX_NEEDLE), np.int32)
        lens = np.zeros(MAX_SCAN_NEEDLES, np.int32)
        for r, i in enumerate(part):
            padded[r, : len(needles[i])] = np.frombuffer(needles[i], np.uint8)
            lens[r] = len(needles[i])
        packed = np.asarray(
            scan_stream(
                rows32, jnp.asarray(padded), jnp.asarray(lens), impl=impl,
                n_real=len(part),
                max_words=scan_word_bucket(max(len(needles[i]) for i in part)),
                valid_words=valid_words,
            )
        )
        bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little")
        for r, i in enumerate(part):
            hits[i] = bits[r, : rows32.shape[0]].astype(bool)
    return hits


def time_scan(fn, *args, reps: int = 5, **kw) -> float:
    import jax

    jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def phase1_scan() -> None:
    import jax
    import jax.numpy as jnp

    from bloomsearch_tpu.rowcache import CHUNK_BYTES, STREAM_STRIDE
    from bloomsearch_tpu.stream_scan import SCAN_WORD_BUCKETS, scan_triton, scan_xla

    valid_words = STREAM_STRIDE // 4
    rng = np.random.default_rng(2)
    G = SCAN_PARITY_CHUNKS
    rows = rng.integers(0, 256, size=(G, CHUNK_BYTES), dtype=np.uint8)
    needles = []
    lo = 1
    for wb in SCAN_WORD_BUCKETS:  # the shortest and longest needle of each bucket
        hi = min(4 * wb - 3, 32)
        for ln in sorted({lo, hi}):
            nd = rng.integers(0, 256, size=ln, dtype=np.uint8)
            nd[0] |= 0x80  # a byte >= 0x80 (the int32 sign bit) in every needle
            needles.append(nd.tobytes())
        lo = hi + 1
    for nd in needles:
        buf = np.frombuffer(nd, np.uint8)
        for a in range(4):  # every start alignment
            g = int(rng.integers(0, G))
            s = 4 * int(rng.integers(0, (STREAM_STRIDE - 4) // 4)) + a
            rows[g, s : s + buf.size] = buf
        g = int(rng.integers(0, G))
        rows[g, STREAM_STRIDE - 1 : STREAM_STRIDE - 1 + buf.size] = buf  # last valid start
        g = int(rng.integers(0, G))
        rows[g, STREAM_STRIDE : STREAM_STRIDE + buf.size] = buf  # overlap: no hit
    rows32 = jnp.asarray(rows.view(np.int32))
    want = np.stack([byte_oracle(rows, nd, STREAM_STRIDE) for nd in needles])
    for impl in ("triton", "xla"):
        got = scan_batches(impl, rows32, needles, valid_words)
        for i, nd in enumerate(needles):
            check(
                np.array_equal(got[i], want[i]),
                f"{impl} scan != byte oracle for a {len(nd)}-byte needle",
            )
        log(
            f"[phase1] scan {impl}: {len(needles)} needles (lengths "
            f"{[len(n) for n in needles]}, all alignments, high bytes) over {G} "
            f"chunks == byte oracle"
        )
    rows32.delete()
    del rows

    # Timings at refscale residency (dense scan-all) and at a sparse
    # launch's size (4 segments of 16,384 chunks).
    for G in (REFSCALE_CHUNKS, SPARSE_CHUNKS):
        stream = jnp.asarray(
            rng.integers(0, 2**32, size=(G, CHUNK_BYTES // 4), dtype=np.uint32).view(np.int32)
        )
        for N in (1, 8):
            for wb in SCAN_WORD_BUCKETS:
                ln = min(4 * wb - 3, 32)
                nd = jnp.asarray(rng.integers(0, 256, size=(8, 32)).astype(np.int32))
                lens = jnp.full((8,), ln, jnp.int32)
                kw = dict(n_real=N, max_words=wb, valid_words=valid_words)
                tt = time_scan(scan_triton, stream, nd, lens, **kw)
                tx = time_scan(scan_xla, stream, nd, lens, **kw)
                log(
                    f"[phase1] scan timing G={G} ({G * CHUNK_BYTES / 1e9:.3f} GB) "
                    f"N={N} words={wb}: triton {tt:.3f} ms, xla {tx:.3f} ms"
                )
        stream.delete()
    jax.clear_caches()


# ---------------------------------------------------------------- phase 2


def refscale_dataset() -> str:
    """The refscale dataset under .data/, generated on first use."""
    from bloomsearch_tpu import perf

    t0 = time.perf_counter()
    d = perf.cached_dataset("refscale", REFSCALE_MB, seed=0, compression="snappy", log=log)
    log(f"[phase2] dataset ready in {time.perf_counter() - t0:.1f} s")
    return d


def smoke_queries():
    import random

    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf

    broad = perf.vocabulary(random.Random(0))[1][0]  # a pool word: in every block
    return [
        ("needle:token", bs.new_query().token(perf.NEEDLE_TOKEN).build()),
        ("needle:field", bs.new_query().field(perf.NEEDLE_FIELD).build()),
        (
            "needle:field_token",
            bs.new_query().field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN).build(),
        ),
        (
            "tree:cnf",
            bs.new_query()
            .match(
                bs.or_(
                    bs.and_(bs.token(perf.NEEDLE_TOKEN), bs.field(perf.NEEDLE_FIELD)),
                    bs.field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN),
                )
            )
            .build(),
        ),
        (
            "regex",
            bs.new_query().field_regex("message", r"alpha needletoken\w+ omega").build(),
        ),
        (f"broad:{broad}", bs.new_query().token(broad).build()),
    ]


def open_engine(store, **overrides):
    import bloomsearch_tpu as bs

    config = bs.BloomSearchEngineConfig(
        row_data_compression="snappy",
        max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000,
        max_query_concurrency=100,
        **overrides,
    )
    engine = bs.BloomSearchEngine(config, store, store)
    engine.start()
    return engine


def run_queries(engine, queries, reps: int, tag: str) -> dict:
    """-> {label: (row multiset, [wall ms])}."""
    out = {}
    for label, q in queries:
        walls, rows = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            rows = engine.query_sync(q, timeout=900)
            walls.append((time.perf_counter() - t0) * 1e3)
        counts = collections.Counter(json.dumps(r, sort_keys=True) for r in rows)
        out[label] = (counts, walls)
        log(
            f"[{tag}] {label}: {len(rows)} rows, walls ms "
            f"{[round(w, 2) for w in walls]}"
        )
    return out


def host_answers(store, queries) -> dict:
    engine = open_engine(store, probe_backend="host", row_cache_bytes=0)
    try:
        return run_queries(engine, queries, reps=1, tag="host")
    finally:
        engine.stop(timeout=600)


def compare(got: dict, want: dict, what: str) -> None:
    for label, (rows, _) in want.items():
        check(got[label][0] == rows, f"{what}: {label} rows differ from the host engine")
        if label.startswith(("needle", "tree", "regex", "broad")):
            check(sum(rows.values()) > 0, f"{label} found no rows")
    log(f"[compare] {what}: every answer equal")


def device_engine_checks(engine, cards: int, probe_launches: int, scan_launches: int) -> None:
    backend, rc = engine._device_backend, engine._row_cache
    check(backend.launches > probe_launches, "no device probe launch during the queries")
    check(rc.launches > scan_launches, "no device scan launch during the queries")
    check(backend._superbanks, "no superbank resident")
    for sb in backend._superbanks.values():
        devs = sb.bank2d.sharding.device_set
        check(
            len(devs) == cards and all(d.platform == PLATFORM for d in devs),
            f"superbank on {devs}",
        )
    devs = rc._bucket.matrix.sharding.device_set
    check(
        len(devs) == cards and all(d.platform == PLATFORM for d in devs), f"stream on {devs}"
    )
    warm = engine.stats().get("warmup", {})
    check(warm.get("probe_aot_programs", 0) > 0, f"no probe program precompiled: {warm}")
    check(warm.get("scan_aot_programs", 0) > 0, f"no scan program precompiled: {warm}")
    check(backend.aot_failures == 0, f"{backend.aot_failures} probe precompiles failed")
    check(rc.aot_failures == 0, f"{rc.aot_failures} scan precompiles failed")
    log(
        f"[checks] {cards} card(s): probe launches {backend.launches - probe_launches}, "
        f"scan launches {rc.launches - scan_launches}, "
        f"{len(backend._superbanks)} superbank(s) + stream on {sorted(str(d) for d in devs)}, "
        f"precompiled {warm['probe_aot_programs']} probe + {warm['scan_aot_programs']} scan "
        f"programs, 0 failed"
    )


def device_answers(store, queries, cards: int, tag: str, compare_scans: bool = False) -> dict:
    engine = open_engine(
        store, probe_backend="device", bank_cache_bytes=6 << 30,
        row_cache_bytes=10 << 30, mesh_devices=cards,
    )
    try:
        t0 = time.perf_counter()
        engine.warmup(block=True, timeout=1200)
        warm_s = time.perf_counter() - t0
        rc = engine._row_cache
        stats = rc.stats()
        log(
            f"[{tag}] warmup {warm_s:.1f} s: {stats['pinned_blocks']} blocks pinned, "
            f"stream {stats['device_bytes'] / 1e9:.2f} GB, superbanks "
            f"{engine._device_backend.total_bytes() / 1e9:.2f} GB; timeline "
            f"{engine.stats().get('warmup')}"
        )
        rc.needle_cache_enabled = False  # every query launches its scan
        backend = engine._device_backend
        p0, s0 = backend.launches, rc.launches
        cnf_before = backend.program_launches["clauses"]
        answers = run_queries(engine, queries, reps=3, tag=tag)
        check(
            backend.program_launches["clauses"] > cnf_before,
            "the tree query never ran the CNF program",
        )
        device_engine_checks(engine, cards, p0, s0)
        if compare_scans:
            compare_scan_impls(engine, queries)
        return answers
    finally:
        engine.stop(timeout=600)


def compare_scan_impls(engine, queries) -> None:
    """End to end: the same warm engine with each stream scan in turn
    (triton, xla, xla, triton), programs precompiled before timing."""
    rc = engine._row_cache
    pinned = list(rc._blocks.values())
    timed = [(label, q) for label, q in queries if not label.startswith("tree")]
    walls = collections.defaultdict(list)
    for impl in ("triton", "xla", "xla", "triton"):
        rc.scan_impl = impl
        t0 = time.perf_counter()
        rc.precompile_scan_programs(pinned)
        compile_s = time.perf_counter() - t0
        for label, q in timed:
            for _ in range(3):
                t0 = time.perf_counter()
                engine.query_sync(q, timeout=900)
                walls[(impl, label)].append((time.perf_counter() - t0) * 1e3)
        log(f"[phase2] scan impl {impl}: precompile {compile_s:.1f} s")
    rc.scan_impl = "triton"
    for label, _ in timed:
        log(
            f"[phase2] e2e {label}: median wall triton "
            f"{statistics.median(walls[('triton', label)]):.2f} ms, xla "
            f"{statistics.median(walls[('xla', label)]):.2f} ms"
        )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--cards", type=int, choices=(1, 4), default=1,
        help="4: run only the engine path over a 4-card mesh (phase 3)",
    )
    args = ap.parse_args()
    # A run stopped by its time limit prints every thread's stack first.
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    t_start = time.perf_counter()
    smi = phase0(args.cards)

    import jax
    import bloomsearch_tpu as bs

    if args.cards == 1:
        t0 = time.perf_counter()
        phase1_probe()
        gc.collect()
        phase1_scan()
        gc.collect()
        log(f"[phase1] done in {time.perf_counter() - t0:.1f} s")
        store = bs.FileSystemDataStore(refscale_dataset())
        queries = smoke_queries()
        want = host_answers(store, queries)
        got = device_answers(store, queries, cards=1, tag="device", compare_scans=True)
        compare(got, want, "one card")
    else:
        store = bs.FileSystemDataStore(refscale_dataset())
        queries = smoke_queries()
        want = host_answers(store, queries)
        four = device_answers(store, queries, cards=4, tag="4 cards")
        gc.collect()
        one = device_answers(store, queries, cards=1, tag="1 card")
        compare(four, want, "four cards vs host")
        compare(one, want, "one card vs host")
        compare(four, one, "four cards vs one card")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    devices = jax.devices()
    log(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BaseException as exc:  # any failed phase: no result line
        if isinstance(exc, SystemExit) and exc.code in (0, None):
            raise
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {exc!r}", file=sys.stderr, flush=True)
        sys.exit(1)
