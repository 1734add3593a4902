"""Headline benchmark: end-to-end query at the reference's own scale.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

The headline metric is the reference's own headline benchmark re-run here:
warm serving-mode engine-query rows/s over a generated needle-in-haystack
dataset at the reference's scale (~12.2M rows / 1.7 GB / 240 blocks,
snappy — bloom_tree_engine_performance_test.go:263-473), with
vs_baseline = rows/s against the reference's 17.08M rows/s / 650 ms
(PERFORMANCE.md:21-29, BASELINE.md). If that phase fails, the line falls
back to the kernel metric below so the headline is never lost.

``extra`` carries the kernel number — membership probes/sec/chip on an
HBM-resident filter bank at the reference's default block bloom params
(10k rows @ 0.1% FPR -> m=143776, k=10; bloom_tree_engine.go:204-229;
north-star 1e9/s/chip per BASELINE.md) — plus ingest, honest-sizing e2e,
concurrency curve, and beyond-HBM (xlscale) phases.

Methodology for the kernel metric: per-launch time is the slope between
chained executions of N_small and N_large distinct probe batches inside
single jit programs, with completion forced by fetching a data-dependent
scalar. This removes host dispatch overhead. Diagnostics go to stderr;
stdout carries only the JSON line, which names the device it ran on. The
bench needs a GPU: without one it prints an error line and exits 1, and it
exits 1 as well (after printing its line) when any phase raised.
"""

import json
import os
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def log_device_mem(tag: str) -> None:
    """Log HBM in use (phase boundaries): each e2e phase must hand the next
    a near-empty device or warmup pins hit RESOURCE_EXHAUSTED."""
    try:
        import jax

        st = jax.local_devices()[0].memory_stats() or {}
        log(
            f"{tag}: device bytes_in_use={st.get('bytes_in_use', 0) / 1e9:.2f} GB"
            f" peak={st.get('peak_bytes_in_use', 0) / 1e9:.2f} GB"
        )
    except Exception:  # platforms without memory_stats
        pass


# Reference e2e baselines (BASELINE.md: M3 Max, ~11.2M rows, selectivity 0%).
REF_ROWS_PER_SEC = 17.08e6
REF_WALL_MS = 650.0


def _timed_needle_queries(engine, store, *, reps: int = 5, warmup_s=None) -> dict:
    """Warmup -> first-query wall -> reps x 3 shapes -> p50 + rows/s.

    reps=5 (15 warm samples): a larger warm population keeps the p50 a
    statement about the engine rather than about one slow query.
    ``warmup_s`` given = engine already warmed by the caller (the
    during-warmup measurement); skip the blocking warmup here."""
    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf

    queries = [
        ("token", bs.new_query().token(perf.NEEDLE_TOKEN).build()),
        ("field", bs.new_query().field(perf.NEEDLE_FIELD).build()),
        (
            "field:token",
            bs.new_query()
            .field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN)
            .build(),
        ),
    ]
    if warmup_s is None:
        t0 = time.perf_counter()
        engine.warmup(block=True, timeout=1800)
        warmup_s = time.perf_counter() - t0
    # The user-visible FIRST query, after warmup (the cold-cliff metric).
    first = perf._run_one_query(engine, store, "first:token", queries[0][1])
    walls = [first["wall_ms"]]
    rows_total = first["candidate_rows"]
    for label, built in queries[1:]:
        perf._run_one_query(engine, store, f"warm:{label}", built)
    for rep in range(reps):
        for label, built in queries:
            r = perf._run_one_query(engine, store, f"{label}#{rep}", built)
            walls.append(r["wall_ms"])
            rows_total = max(rows_total, r["candidate_rows"])
    p50 = statistics.median(walls[1:])
    rows_per_sec = rows_total / (p50 / 1e3) if p50 > 0 else 0.0
    return {
        "rows": rows_total,
        "p50_ms": round(p50, 2),
        "rows_per_sec": round(rows_per_sec),
        "first_query_ms": round(first["wall_ms"], 2),
        "warmup_s": round(warmup_s, 1),
        "backend": "device" if engine._device_backend is not None else "host",
    }


def _e2e_variant(target_mb: int, block_items, **engine_overrides) -> dict:
    """Generate a dataset, run warm needle queries, report p50 + rows/s."""
    from bloomsearch_tpu import perf
    from bloomsearch_tpu.engine import _default_compression

    with tempfile.TemporaryDirectory(prefix="bloomsearch-bench-") as d:
        args = SimpleNamespace(
            dir=d,
            compression=_default_compression(),
            concurrency=100,
            probe_backend="auto",
            layout="classic",
            block_items=block_items,
            target_mb=target_mb,
            seed=0,
        )
        t0 = time.perf_counter()
        perf.cmd_generate(args)
        log(f"e2e dataset ({block_items=}) generated in {time.perf_counter() - t0:.1f}s")

        engine, store = perf._engine(args, **engine_overrides)
        if engine._row_cache is not None:
            # Measure the real scan path: the needle-bitmap cache would turn
            # repeated benchmark needles into pure cache hits.
            engine._row_cache.needle_cache_enabled = False
        try:
            return _timed_needle_queries(engine, store)
        finally:
            engine.stop(timeout=300)


REFSCALE_TARGET_MB = 1600
REF_ROWS = 11_214_340  # the reference benchmark's dataset (PERFORMANCE.md:21)


def refscale_bench() -> dict:
    """e2e at the reference's OWN benchmark scale (PERFORMANCE.md:21-29:
    ~11.2M rows / 1.6 GB / 10 files / 100 blocks, snappy, 00-09 partitions).

    The dataset replicates the reference perf harness's shape AND physical
    layout (bloom_tree_engine_performance_test.go:14-60: 10 MB row groups,
    200 MB buffered flushes, block blooms sized by the 1M-row cap) and is
    kept under the checkout's .data/ across bench runs. rows/s follows the reference's
    own methodology: candidate rows (the full dataset at this selectivity)
    divided by needle-query wall time.
    """
    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf
    from bloomsearch_tpu.engine import _default_compression

    comp = _default_compression()
    cache = perf.cached_dataset("refscale", REFSCALE_TARGET_MB, seed=0, compression=comp, log=log)

    store = bs.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    blocks = [b for mf in files for b in mf.metadata.data_blocks]
    rows = sum(b.rows for b in blocks)
    raw_bytes = sum(b.uncompressed_size for b in blocks)

    config = bs.BloomSearchEngineConfig(
        row_data_compression=comp,
        max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000,
        max_query_concurrency=100,
        probe_backend="auto",
        bank_cache_bytes=6 << 30,
        # Serving mode: pin the packed rows in device memory; needle scans
        # run on-device (sparse segment slices for needle queries). Warmup
        # pays the one-time pin uploads.
        row_cache_bytes=10 << 30,
        # Restart sidecar: packed serving state persists next to the
        # dataset cache, so the restart phase below measures the real
        # second-start story (mmap + h2d instead of decode + pack).
        serving_cache_dir=cache + "-sidecar",
    )
    engine = bs.BloomSearchEngine(config, store, store)
    engine.start()
    try:
        if engine._row_cache is not None:
            # Measure the real scan path (repeated benchmark needles would
            # otherwise become pure bitmap-cache hits).
            engine._row_cache.needle_cache_enabled = False
        # Queries DURING warmup: incremental warmup compiles scan programs
        # on a reserved final shape before the pin pass, so a query racing
        # the warmup should run far better than cold. (t_s, wall_ms) pairs.
        during: list = []
        q_token = bs.new_query().token(perf.NEEDLE_TOKEN).build()
        t0 = time.perf_counter()
        fut = engine.warmup(block=False)
        while not fut.done():
            t = time.perf_counter() - t0
            qt0 = time.perf_counter()
            try:
                engine.query_sync(q_token, timeout=900)
                during.append(
                    [round(t, 1), round((time.perf_counter() - qt0) * 1e3, 1)]
                )
            except Exception as exc:
                during.append([round(t, 1), f"error:{exc!r}"])
            # Pace ~1 query / 10 s so the probes don't starve the warmup's
            # uploads.
            for _ in range(50):
                if fut.done():
                    break
                time.sleep(0.2)
        fut.result(timeout=1800)
        warmup_s = time.perf_counter() - t0
        log(f"refscale during-warmup (t_s, wall_ms): {during}")
        # Worst during-warmup query's phase breakdown (diagnosis for the
        # during-warmup SLO: which phase held it — plan/probe, prescan
        # launch wait, or block tasks).
        worst_timing = None
        try:
            timings = list(engine._query_timings)
            if timings:
                worst_timing = max(timings, key=lambda t: t.get("total_s", 0))
        except Exception:
            pass
        out = _timed_needle_queries(engine, store, warmup_s=warmup_s)
        conc = {}
        qps_curve = {}
        for n in (16, 32, 64, 128):
            # Best-of-2: one stall mid-burst otherwise prints a
            # non-monotone curve.
            r = _concurrent_queries(engine, rows, n_threads=n)
            r2 = _concurrent_queries(engine, rows, n_threads=n)
            if "e2e_refscale_concurrent_error" not in r2 and (
                "e2e_refscale_concurrent_error" in r
                or r2["e2e_refscale_concurrent_qps"]
                > r.get("e2e_refscale_concurrent_qps", 0)
            ):
                r = r2
            if n == 16:
                conc = r
            err = r.get("e2e_refscale_concurrent_error")
            qps_curve[str(n)] = (
                f"error:{err}"
                if err
                else {
                    "qps": r["e2e_refscale_concurrent_qps"],
                    "p50_ms": r["e2e_refscale_concurrent_p50_ms"],
                    "p95_ms": r["e2e_refscale_concurrent_p95_ms"],
                    "p99_ms": r["e2e_refscale_concurrent_p99_ms"],
                    "max_over_min": r[
                        "e2e_refscale_concurrent_fairness_max_over_min"
                    ],
                }
            )
            log(f"concurrency {n}: {r}")
        rc_stats = (
            engine._row_cache.stats() if engine._row_cache is not None else None
        )
        warm_timeline = engine.stats().get("warmup", {})
        sidecar_stats = (
            engine._serving_cache.stats() if engine._serving_cache else None
        )
    finally:
        engine.stop(timeout=600)

    # RESTART phase: a second engine start in the same
    # environment — packed serving state streams from the sidecar (mmap +
    # h2d, no decode/pack) and jit programs re-read from the persistent
    # compile cache. warm_ready_restart_s is the time until a query runs
    # compiled programs end to end; p50 must match the first engine's.
    restart: dict = {}
    try:
        engine2 = bs.BloomSearchEngine(config, store, store)
        engine2.start()
        try:
            if engine2._row_cache is not None:
                engine2._row_cache.needle_cache_enabled = False
            rt0 = time.perf_counter()
            engine2.warmup(block=True, timeout=1800)
            restart["e2e_refscale_warm_ready_restart_s"] = round(
                time.perf_counter() - rt0, 1
            )
            walls = []
            q_token2 = bs.new_query().token(perf.NEEDLE_TOKEN).build()
            for _ in range(5):
                qt0 = time.perf_counter()
                engine2.query_sync(q_token2, timeout=600)
                walls.append((time.perf_counter() - qt0) * 1e3)
            restart["e2e_refscale_restart_p50_ms"] = round(
                statistics.median(walls), 1
            )
            restart["e2e_refscale_restart_first_query_ms"] = round(walls[0], 1)
            tl = engine2.stats().get("warmup", {})
            restart["e2e_refscale_restart_warm_ready_s"] = tl.get("warm_ready_s")
            restart["e2e_refscale_restart_timeline"] = tl
            if engine2._serving_cache is not None:
                restart["e2e_refscale_restart_sidecar"] = (
                    engine2._serving_cache.stats()
                )
        finally:
            engine2.stop(timeout=600)
    except Exception as exc:
        log(f"restart phase failed: {exc!r}")
        restart["e2e_refscale_restart_error"] = repr(exc)
    rows_per_sec = out["rows_per_sec"]
    during_walls = [w for _, w in during if isinstance(w, (int, float))]
    return {
        "e2e_refscale_rows": rows,
        "e2e_refscale_files": len(files),
        "e2e_refscale_blocks": len(blocks),
        "e2e_refscale_raw_mb": round(raw_bytes / 1e6),
        "e2e_refscale_candidate_rows": out["rows"],
        "e2e_refscale_p50_ms": out["p50_ms"],
        "e2e_refscale_rows_per_sec": rows_per_sec,
        "e2e_refscale_vs_ref": round(rows_per_sec / REF_ROWS_PER_SEC, 3),
        "e2e_refscale_first_query_ms": out["first_query_ms"],
        "e2e_refscale_warmup_s": out["warmup_s"],
        "e2e_refscale_backend": out["backend"],
        # Honesty: the reference number this compares against was measured
        # on an M3 Max (12 cores) at ~100-way query concurrency over 11.2M
        # rows / 1.6 GB; this runs the same dataset scale and counting
        # methodology on this host (see cpu_count in extra).
        "e2e_refscale_ref_rows": REF_ROWS,
        "e2e_refscale_ref_rows_per_sec": REF_ROWS_PER_SEC,
        **(
            {
                "e2e_refscale_serving_pinned_blocks": rc_stats["pinned_blocks"],
                "e2e_refscale_serving_gb": round(rc_stats["bytes"] / 1e9, 2),
                "e2e_refscale_serving_host_gb": round(
                    rc_stats["host_bytes"] / 1e9, 3
                ),
                "e2e_refscale_serving_device_gb": round(
                    rc_stats["device_bytes"] / 1e9, 2
                ),
            }
            if rc_stats
            else {}
        ),
        **conc,
        "e2e_refscale_qps_curve": qps_curve,
        "e2e_refscale_during_warmup": during,
        **(
            {
                "e2e_refscale_during_warmup_first_ms": during_walls[0],
                "e2e_refscale_during_warmup_p50_ms": round(
                    statistics.median(during_walls), 1
                ),
                "e2e_refscale_during_warmup_worst_ms": round(
                    max(during_walls), 1
                ),
            }
            if during_walls
            else {}
        ),
        **(
            {"e2e_refscale_during_warmup_worst_breakdown": worst_timing}
            if worst_timing
            else {}
        ),
        "e2e_refscale_warm_ready_s": warm_timeline.get("warm_ready_s"),
        "e2e_refscale_warmup_timeline": warm_timeline,
        **({"e2e_refscale_sidecar": sidecar_stats} if sidecar_stats else {}),
        **restart,
    }


XLSCALE_TARGET_MB = 8192


def xlscale_bench() -> dict:
    """Beyond-budget scale: ~8 GB raw — the stream cannot
    fully pin (row_cache_bytes=4 GB -> ~40% residency) and the filter banks
    exceed bank_cache_bytes (2 GB), so every query exercises the partial-
    residency machinery: pinned-hit + cold-decode mix, LRU evict-in-place
    (stable matrix shape), background cache-warm pins, and sparse cold bank
    probes. Dataset kept under .data/ like refscale. rows/s follows the reference's methodology (dataset
    rows / needle-query wall) and compares to the same 17.08M rows/s — the
    reference's architecture is scale-indifferent (its 100 GB harness runs
    the same per-row scan), so >= 1.0 here is the scale-holding claim.
    """
    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf
    from bloomsearch_tpu.engine import _default_compression

    comp = _default_compression()
    cache = perf.cached_dataset("xlscale", XLSCALE_TARGET_MB, seed=1, compression=comp, log=log)

    store = bs.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    blocks = [b for mf in files for b in mf.metadata.data_blocks]
    rows = sum(b.rows for b in blocks)
    raw_bytes = sum(b.uncompressed_size for b in blocks)

    config = bs.BloomSearchEngineConfig(
        row_data_compression=comp,
        max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000,
        max_query_concurrency=100,
        probe_backend="auto",
        bank_cache_bytes=2 << 30,   # < total banks: sparse cold probes live
        row_cache_bytes=3584 << 20, # < packed stream: ~37% residency
    )
    engine = bs.BloomSearchEngine(config, store, store)
    engine.start()
    try:
        if engine._row_cache is not None:
            engine._row_cache.needle_cache_enabled = False
        out = _timed_needle_queries(engine, store, reps=4)
        # First-query phase breakdown (isolates the cause of a slow first
        # query).
        first_breakdown = None
        try:
            timings = list(engine._query_timings)
            if timings:
                first_breakdown = timings[0]
        except Exception:
            pass
        # CHURN phase: the working set must exceed
        # residency in the captured artifact. Each row carries a unique
        # uid token, so sweeping uid point-lookups across the dataset
        # touches a different block per query — promotions evict warm
        # blocks (admission-controlled by the churn budget) while queries
        # keep serving from the inline host scan. p50 under ACTIVE
        # eviction is the steady-state beyond-HBM serving claim.
        churn_walls: list = []
        churn_errors = 0
        n_churn = 80
        for i in range(n_churn):
            uid = int((rows - 10) * (i / n_churn))
            q = bs.new_query().token(f"u{uid:08x}").build()
            qt0 = time.perf_counter()
            try:
                res = engine.query_sync(q, timeout=600)
                churn_walls.append((time.perf_counter() - qt0) * 1e3)
                if i == 0:
                    log(f"churn probe query -> {len(res)} rows")
            except Exception as exc:
                churn_errors += 1
                log(f"churn query failed: {exc!r}")
        churn_walls.sort()
        rc = engine._row_cache.stats() if engine._row_cache is not None else {}
        dev = engine._device_backend.stats() if engine._device_backend else {}
        churn_skipped = engine.stats().get("background_pins_churn_skipped", 0)
    finally:
        engine.stop(timeout=600)
    rows_per_sec = out["rows_per_sec"]
    residency = rc.get("pinned_blocks", 0) / max(len(blocks), 1)
    return {
        "e2e_xlscale_rows": rows,
        "e2e_xlscale_raw_gb": round(raw_bytes / 1e9, 2),
        "e2e_xlscale_blocks": len(blocks),
        "e2e_xlscale_p50_ms": out["p50_ms"],
        "e2e_xlscale_rows_per_sec": rows_per_sec,
        "e2e_xlscale_vs_ref": round(rows_per_sec / REF_ROWS_PER_SEC, 3),
        "e2e_xlscale_first_query_ms": out["first_query_ms"],
        **(
            {"e2e_xlscale_first_query_breakdown": first_breakdown}
            if first_breakdown
            else {}
        ),
        "e2e_xlscale_warmup_s": out["warmup_s"],
        "e2e_xlscale_residency_frac": round(residency, 3),
        "e2e_xlscale_pinned_blocks": rc.get("pinned_blocks"),
        "e2e_xlscale_serving_device_gb": round(rc.get("device_bytes", 0) / 1e9, 2),
        "e2e_xlscale_serving_host_gb": round(rc.get("host_bytes", 0) / 1e9, 3),
        "e2e_xlscale_pins": rc.get("pins"),
        "e2e_xlscale_evictions": rc.get("evictions"),
        "e2e_xlscale_compactions": rc.get("compactions"),
        "e2e_xlscale_bg_pins_churn_skipped": churn_skipped,
        **(
            {
                "e2e_xlscale_churn_queries": len(churn_walls),
                "e2e_xlscale_churn_p50_ms": round(
                    _percentile(churn_walls, 0.50), 1
                ),
                "e2e_xlscale_churn_p95_ms": round(
                    _percentile(churn_walls, 0.95), 1
                ),
                "e2e_xlscale_churn_errors": churn_errors,
            }
            if churn_walls
            else {}
        ),
        "e2e_xlscale_bank_stats": dev,
    }


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


XXLSCALE_TARGET_MB = 30720


def xxlscale_bench() -> dict:
    """Scale toward the reference harness's ceiling: ~30 GB raw / ~4000 blocks. The filter banks alone (~5+ GB) exceed
    bank_cache_bytes, so warmup stops at the bank budget
    (timeline.bank_budget_hit) and the un-warmed tail serves via per-query
    sparse cold probes; the packed row stream exceeds row_cache_bytes by
    ~10x, so serving runs at ~10% residency. The reference's architecture
    is scale-indifferent (its 100 GB harness runs the same per-row scan),
    so vs_ref >= 1.0 here is the scale-holding claim. Dataset kept under
    .data/ (generate with scripts/gen_xxlscale.py) and SKIPPED (not failed)
    when absent, so bench runs without it still print every other phase."""
    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf
    from bloomsearch_tpu.engine import _default_compression

    comp = _default_compression()
    cache = perf.cached_dataset(
        "xxlscale", XXLSCALE_TARGET_MB, seed=2, compression=comp, log=log, generate=False
    )
    if cache is None:
        return {"xxlscale_skipped": "dataset absent (scripts/gen_xxlscale.py)"}

    store = bs.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    blocks = [b for mf in files for b in mf.metadata.data_blocks]
    rows = sum(b.rows for b in blocks)
    raw_bytes = sum(b.uncompressed_size for b in blocks)
    total_bank_bytes = sum(
        g.size for mf in files for g in mf.metadata.bank_groups
    )

    config = bs.BloomSearchEngineConfig(
        row_data_compression=comp,
        max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000,
        max_query_concurrency=100,
        probe_backend="auto",
        bank_cache_bytes=2 << 30,    # << total banks: budget-capped warmup
        row_cache_bytes=3 << 30,     # ~10% residency
    )
    engine = bs.BloomSearchEngine(config, store, store)
    engine.start()
    try:
        if engine._row_cache is not None:
            engine._row_cache.needle_cache_enabled = False
        out = _timed_needle_queries(engine, store, reps=3)
        # First-query phase breakdown (xlscale captures the same; at 8%
        # residency the first query's gap over steady p50 needs a cause
        # on record, not a guess).
        first_breakdown = None
        try:
            timings = list(engine._query_timings)
            if timings:
                first_breakdown = timings[0]
        except Exception:
            pass
        rc = engine._row_cache.stats() if engine._row_cache is not None else {}
        dev = engine._device_backend.stats() if engine._device_backend else {}
        timeline = engine.stats().get("warmup", {})
    finally:
        engine.stop(timeout=600)
    rows_per_sec = out["rows_per_sec"]
    return {
        "e2e_xxlscale_rows": rows,
        "e2e_xxlscale_raw_gb": round(raw_bytes / 1e9, 2),
        "e2e_xxlscale_blocks": len(blocks),
        "e2e_xxlscale_files": len(files),
        "e2e_xxlscale_total_bank_gb": round(total_bank_bytes / 1e9, 2),
        "e2e_xxlscale_p50_ms": out["p50_ms"],
        "e2e_xxlscale_rows_per_sec": rows_per_sec,
        "e2e_xxlscale_vs_ref": round(rows_per_sec / REF_ROWS_PER_SEC, 3),
        "e2e_xxlscale_first_query_ms": out["first_query_ms"],
        "e2e_xxlscale_first_query_breakdown": first_breakdown,
        "e2e_xxlscale_warmup_s": out["warmup_s"],
        "e2e_xxlscale_bank_budget_hit": timeline.get("bank_budget_hit"),
        "e2e_xxlscale_residency_frac": round(
            rc.get("pinned_blocks", 0) / max(len(blocks), 1), 3
        ),
        "e2e_xxlscale_pinned_blocks": rc.get("pinned_blocks"),
        "e2e_xxlscale_serving_device_gb": round(
            rc.get("device_bytes", 0) / 1e9, 2
        ),
        "e2e_xxlscale_bank_stats": dev,
    }


def _concurrent_queries(engine, dataset_rows: int, n_threads: int = 16) -> dict:
    """N warm needle queries in flight at once (the reference's own numbers
    ran at ~100-way concurrency INSIDE one query; this measures cross-query
    amortization — probe/scan launch combiners coalesce concurrent queries
    into shared device launches). Per-query walls are recorded so the curve
    carries tail latency (p50/p95/p99) and fairness (max/min wall within
    the burst), not just aggregate qps."""
    import threading

    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf

    shapes = [
        bs.new_query().token(perf.NEEDLE_TOKEN).build(),
        bs.new_query().field(perf.NEEDLE_FIELD).build(),
        bs.new_query().field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN).build(),
    ]
    errors: list = []
    walls_ms = [0.0] * n_threads

    def one(i: int):
        try:
            qt0 = time.perf_counter()
            engine.query_sync(shapes[i % len(shapes)], timeout=600)
            walls_ms[i] = (time.perf_counter() - qt0) * 1e3
        except Exception as exc:  # pragma: no cover - diagnostics only
            errors.append(exc)

    threads = [
        threading.Thread(target=one, args=(i,), daemon=True)
        for i in range(n_threads)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        # A hung thread means the wall/qps numbers below would silently
        # describe an unfinished run.
        return {"e2e_refscale_concurrent_error": "timeout: query thread still running"}
    if errors:
        return {"e2e_refscale_concurrent_error": repr(errors[0])}
    ws = sorted(walls_ms)
    return {
        "e2e_refscale_concurrent_queries": n_threads,
        "e2e_refscale_concurrent_wall_ms": round(wall * 1e3, 1),
        "e2e_refscale_concurrent_qps": round(n_threads / wall, 1),
        "e2e_refscale_concurrent_agg_rows_per_sec": round(
            n_threads * dataset_rows / wall
        ),
        "e2e_refscale_concurrent_p50_ms": round(_percentile(ws, 0.50), 1),
        "e2e_refscale_concurrent_p95_ms": round(_percentile(ws, 0.95), 1),
        "e2e_refscale_concurrent_p99_ms": round(_percentile(ws, 0.99), 1),
        "e2e_refscale_concurrent_max_ms": round(ws[-1], 1),
        "e2e_refscale_concurrent_min_ms": round(ws[0], 1),
        # Fairness: a burst where late members serialize behind earlier
        # launches shows up as max/min >> 1.
        "e2e_refscale_concurrent_fairness_max_over_min": round(
            ws[-1] / max(ws[0], 1e-9), 2
        ),
    }


def merge_bench() -> dict:
    """Merge/compaction throughput + query latency during the merge.
    Hardlink-copies the cached refscale dataset (files
    are immutable, so links are safe and instant), expires partition "00"
    via a conditioned-TTL predicate (exercising expiry + file-filter
    rebuild), then merges while needle queries run concurrently. Reference
    shape: MergeStats rates per operation
    (/root/reference/bloom_tree_engine.go:1355-1371)."""
    import shutil
    import threading

    import bloomsearch_tpu as bs
    from bloomsearch_tpu import perf
    from bloomsearch_tpu.engine import _default_compression
    from bloomsearch_tpu.query import partition_equals
    from bloomsearch_tpu import prefilter_expiry, partition

    comp = _default_compression()
    src = perf.cached_dataset(
        "refscale", REFSCALE_TARGET_MB, seed=0, compression=comp, log=log, generate=False
    )
    if src is None:
        return {"merge_error": "refscale dataset missing"}
    with tempfile.TemporaryDirectory(prefix="bloomsearch-merge-") as d:
        for name in os.listdir(src):
            if name == "GENERATION_COMPLETE":
                continue
            p = os.path.join(src, name)
            if os.path.isfile(p):
                os.link(p, os.path.join(d, name))
        store = bs.FileSystemDataStore(d)
        config = bs.BloomSearchEngineConfig(
            row_data_compression=comp,
            max_row_group_bytes=10 * 1024 * 1024,
            max_row_group_rows=1_000_000,
            max_query_concurrency=100,
            probe_backend="host",  # storage-side phase: no device claims
            ttl_predicate=prefilter_expiry(
                partition(partition_equals("00"))
            ),
        )
        engine = bs.BloomSearchEngine(config, store, store)
        engine.start()
        try:
            q_token = bs.new_query().token(perf.NEEDLE_TOKEN).build()
            before_rows = engine.query_sync(q_token, timeout=600)
            lost_parts = {r.get("part") for r in before_rows} & {"00"}
            walls_before = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.query_sync(q_token, timeout=600)
                walls_before.append((time.perf_counter() - t0) * 1e3)

            merge_stats: list = []

            def run_merge():
                merge_stats.append(engine.merge())

            mt = threading.Thread(target=run_merge, daemon=True)
            t_merge0 = time.perf_counter()
            mt.start()
            walls_during: list = []
            while mt.is_alive():
                t0 = time.perf_counter()
                engine.query_sync(q_token, timeout=600)
                walls_during.append((time.perf_counter() - t0) * 1e3)
                mt.join(timeout=0.5)
            mt.join(timeout=600)
            merge_wall = time.perf_counter() - t_merge0
            after_rows = engine.query_sync(q_token, timeout=600)
            expected = len(before_rows) - sum(
                1 for r in before_rows if r.get("part") in lost_parts
            )
            ms = merge_stats[0] if merge_stats else None
            return {
                "merge_rows_per_sec": round(ms.rows_per_second) if ms else None,
                "merge_bytes_per_sec": round(ms.bytes_per_second) if ms else None,
                "merge_rows_processed": ms.rows_processed if ms else None,
                "merge_files_processed": ms.files_processed if ms else None,
                "merge_wall_s": round(merge_wall, 1),
                "e2e_p50_before_merge_ms": round(
                    statistics.median(walls_before), 1
                ),
                "e2e_p50_during_merge_ms": round(
                    statistics.median(walls_during), 1
                )
                if walls_during
                else None,
                "e2e_queries_during_merge": len(walls_during),
                "merge_results_exact": len(after_rows) == expected,
            }
        finally:
            engine.stop(timeout=600)


def ingest_bench(n_rows: int = 60_000) -> dict:
    """Dict-row ingest throughput (rows pre-built so generation cost is
    excluded; BASELINE.md lists ingest rows/sec as a target — the reference
    was generator-bound at ~13.4 MB/s ≈ ~100k rows/s)."""
    import random
    import string

    import bloomsearch_tpu as bs

    rng = random.Random(0)

    def row(i):
        return {
            "svc": rng.choice(["auth", "pay", "sched"]),
            "level": rng.choice(["info", "warn", "error"]),
            "msg": " ".join(
                "".join(rng.choices(string.ascii_lowercase + string.digits,
                                    k=rng.randrange(3, 12)))
                for _ in range(6)
            ),
            "n": i,
        }

    rows = [row(i) for i in range(n_rows)]
    nbytes = sum(len(repr(r)) for r in rows)
    with tempfile.TemporaryDirectory(prefix="bloomsearch-ingest-") as d:
        from bloomsearch_tpu import FileSystemDataStore

        store = FileSystemDataStore(d)
        config = bs.BloomSearchEngineConfig(
            max_buffered_rows=20_000, max_buffered_bytes=16 << 20,
            probe_backend="host",  # measure the host pipeline, not bank warms
        )
        engine = bs.BloomSearchEngine(config, store, store)
        engine.start()
        t0 = time.perf_counter()
        for i in range(0, n_rows, 2000):
            engine.ingest_rows(rows[i : i + 2000], timeout=120)
        engine.flush(timeout=300)
        dt = time.perf_counter() - t0
        engine.stop(timeout=300)
    return {
        "ingest_rows_per_sec": round(n_rows / dt),
        "ingest_mb_per_sec": round(nbytes / dt / 1e6, 1),
    }


def e2e_query_bench(target_mb: int = 48) -> dict:
    """Two variants of the reference's needle benchmark shape:

    - parity: block filters sized by rows like the reference (saturates on
      this high-cardinality data exactly like the reference's own benchmark
      does, so most blocks get scanned) — the apples-to-apples number.
    - honest: block_bloom_expected_items sized to distinct keys/block, the
      framework's documented recommendation — blooms prune nearly every
      block and the query is bank-probe-bound.

    The reference's 650 ms / 17.08M rows/s ran at ~51x effective concurrency
    on an M3 Max; cpu_count is reported so per-core throughput is comparable.

    The parity variant runs in serving mode (device row cache): saturated
    filters make every query scan-bound, and the documented production
    answer is pinning rows in device memory.
    """

    parity = _e2e_variant(target_mb, block_items=None, row_cache_bytes=2 << 30)
    honest = _e2e_variant(target_mb, block_items=131_072)
    return {
        "e2e_rows": parity["rows"],
        "e2e_query_p50_ms": parity["p50_ms"],
        "e2e_query_rows_per_sec": parity["rows_per_sec"],
        "e2e_vs_ref_rows_per_sec": round(parity["rows_per_sec"] / REF_ROWS_PER_SEC, 3),
        "e2e_first_query_ms": parity["first_query_ms"],
        "e2e_honest_sizing_p50_ms": honest["p50_ms"],
        "e2e_honest_sizing_rows_per_sec": honest["rows_per_sec"],
        "e2e_honest_vs_ref_rows_per_sec": round(
            honest["rows_per_sec"] / REF_ROWS_PER_SEC, 3
        ),
        "e2e_honest_first_query_ms": honest["first_query_ms"],
        "e2e_backend": parity["backend"],
        # Scale honesty: this phase runs at target_mb (48 MB default), far
        # below the reference's 1.6 GB — the refscale phase is the
        # apples-to-apples comparison.
        "e2e_target_mb": target_mb,
        "cpu_count": os.cpu_count(),
    }


def device_info() -> dict:
    import subprocess

    import jax

    devices = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    except OSError:  # no NVIDIA driver on this host
        smi = None
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": smi,
    }


def kernel_bench(log_fn=log) -> tuple[float, dict]:
    """Probe per-launch time on a 32,768-block bank at the reference's
    default block bloom params -> (probes/s, extra keys)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from bloomsearch_tpu.bloom import BloomParams
    from bloomsearch_tpu.bloom.device_probe import probe_bank_xla

    params = BloomParams(10_000, 0.001)
    w = params.num_words
    rows = 3 * w
    k = params.k
    t_terms = 4
    num_blocks = 32_768
    rng = np.random.default_rng(0)
    bank2d = jax.device_put(
        jnp.asarray(rng.integers(0, 2**32, size=(rows, num_blocks), dtype=np.uint32))
    )
    bank2d.block_until_ready()
    log_fn(f"bank uploaded: rows={rows} blocks={num_blocks} ({rows * num_blocks * 4 / 1e9:.2f} GB)")

    @jax.jit
    def chained(bank, frs, shs):
        def body(total, fs):
            fr_i, sh_i = fs
            # Serialize launches: the barrier makes launch i+1 depend on
            # launch i's reduced output. Without it XLA may overlap
            # independent launches and the slope under-counts per-launch
            # time.
            fr_i, _ = jax.lax.optimization_barrier((fr_i, total))
            out = probe_bank_xla(bank, fr_i, sh_i, k).astype(jnp.int32)
            return total + out[0, 0] + out[-1, -1], ()

        total, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), (frs, shs))
        return total

    def run(n: int, reps: int = 7) -> float:
        frs = jnp.asarray(rng.integers(0, 3 * w, size=(n, t_terms * k)).astype(np.int32))
        shs = jnp.asarray(rng.integers(0, 32, size=(n, t_terms * k)).astype(np.int32))
        float(chained(bank2d, frs, shs))  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(chained(bank2d, frs, shs))
            best = min(best, time.perf_counter() - t0)
        return best

    n_small, n_large = 32, 4096
    per_launch = max((run(n_large) - run(n_small)) / (n_large - n_small), 1e-9)
    probes_per_sec = t_terms * num_blocks / per_launch
    log_fn(f"per-launch: {per_launch * 1e6:.1f} us | {probes_per_sec / 1e9:.3f} B probes/s")
    bank2d.delete()
    return probes_per_sec, {"kernel_per_launch_us": round(per_launch * 1e6, 1)}


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bloomsearch_tpu import route

    cache_dir = route.enable_compile_cache()  # before the first compile
    device = device_info()
    log(f"device: {device}; compile cache {cache_dir}")
    if not route.is_accelerator(device["platform"]):
        print(json.dumps({"metric": None, "value": None, "error": "no GPU found", "device": device}))
        return 1

    import gc

    extra: dict = {"device": device}
    failed: list = []

    def phase(name: str, fn) -> None:
        try:
            extra.update(fn())
        except Exception as exc:
            log(f"{name} bench failed: {exc!r}")
            extra[f"{name}_error"] = repr(exc)
            failed.append(name)
        gc.collect()  # drop the phase's device buffers before the next

    probes_per_sec = None
    try:
        probes_per_sec, kernel_extra = kernel_bench()
        extra.update(kernel_extra)
    except Exception as exc:
        log(f"kernel bench failed: {exc!r}")
        extra["kernel_error"] = repr(exc)
        failed.append("kernel")
    # Ingest first: the e2e phases leave background threads/teardown that
    # contend for the host and depress a following ingest measurement.
    phase("ingest", ingest_bench)
    phase("e2e", e2e_query_bench)
    log_device_mem("before refscale")
    phase("refscale", refscale_bench)
    # Merge phase is host-side (hardlinked copy of the refscale set): run it
    # between the device phases so its CPU work doesn't contend.
    phase("merge", merge_bench)
    log_device_mem("before xlscale")
    phase("xlscale", xlscale_bench)
    log_device_mem("before xxlscale")
    phase("xxlscale", xxlscale_bench)
    log_device_mem("after xxlscale")
    # Multicore hosts: block-pipeline scaling (skipped at nproc=1 — nothing
    # to measure; the cpu-gated test asserts >= 0.7x linear where cores exist).
    if (os.cpu_count() or 1) > 1:
        from bloomsearch_tpu.perf import measure_block_pipeline_scaling

        phase("scaling", lambda: {"block_pipeline_scaling": measure_block_pipeline_scaling(log=log)})

    # Headline: the reference's OWN benchmark (refscale serving-mode scan)
    # when it ran; kernel probes/sec as fallback.
    extra["bloom_probes_per_sec_per_chip"] = probes_per_sec
    if "e2e_refscale_rows_per_sec" in extra:
        headline = {
            "metric": "e2e_refscale_rows_per_sec",
            "value": extra["e2e_refscale_rows_per_sec"],
            "unit": "rows/s",
            "vs_baseline": extra["e2e_refscale_vs_ref"],
        }
    else:
        headline = {
            "metric": "bloom_probes_per_sec_per_chip",
            "value": probes_per_sec,
            "unit": "probes/s",
            "vs_baseline": None,
        }
    if failed:
        extra["failed_phases"] = failed
    # Full record to a gitignored file (a capture limit may cut the stdout
    # line), then a size-bounded line to stdout: the raw during-warmup pair
    # list is the one unbounded key, so downsample it on the line.
    full = {**headline, "extra": extra}
    record = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench", "BENCH_SELF.json")
    try:
        os.makedirs(os.path.dirname(record), exist_ok=True)
        with open(record, "w") as fh:
            json.dump(full, fh, indent=1)
    except OSError as exc:
        log(f"{record} write failed: {exc!r}")
    during_full = extra.get("e2e_refscale_during_warmup")
    if isinstance(during_full, list) and len(during_full) > 24:
        extra["e2e_refscale_during_warmup"] = (
            during_full[:8]
            + during_full[len(during_full) // 2 - 4 : len(during_full) // 2 + 4]
            + during_full[-8:]
        )
        extra["e2e_refscale_during_warmup_downsampled"] = (
            f"{len(during_full)} samples; full list in {record}"
        )
    print(json.dumps({**headline, "extra": extra}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
