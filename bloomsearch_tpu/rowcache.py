"""Device row cache: HBM-pinned row data with on-device candidate scanning.

Serving mode for hot data. The host candidate scan (scan.py) avoids
JSON-parsing non-matching rows but still burns host CPU re-reading and
re-scanning block bytes on every query. Here a block's decompressed row
buffer is pinned in HBM **once** — lowercased and chunked into overlapped
512-byte stream chunks packed 4-bytes-per-int32 and appended to ONE shared
stream matrix ``int32[cap_chunks, 128]`` — and each query's needle scan runs
on the device as ONE SWAR scan launch over the resident stream
(stream_scan.py; scan-all, so a needle's full-residency bitmap is
cacheable and every launch has one program shape):

- **Stream chunks, not width-bucketed row matrices** (round 3): each chunk
  carries STREAM_STRIDE=480 payload bytes plus the next 32 bytes duplicated,
  so every <=32-byte window starting in the payload region is contained in
  exactly one chunk. Rows are NOT padded to a width class — the stream is
  ~1.07x the raw bytes where the per-block width buckets were ~3.6x on
  log-shaped data (512-byte bucket for ~140-byte rows), which divides HBM
  footprint, pin-upload time, and scan traffic by the same ~3.4x.
- The scan emits per-CHUNK hit bits; a hit in chunk c means a match
  starting somewhere in its payload, so the candidate rows are every row
  overlapping bytes [c*480, c*480+480+len-1) — the same span-overlap
  marking rule as the host scanner (bs_scan_candidates / scan.py), made
  conservative at chunk granularity. Exact verification downstream keeps
  zero false positives; chunk granularity only ever ADDS candidates.
- all of a query's needles scan together (needle axis vectorized, padded to
  a small bucket), and
- concurrent block scans coalesce through a windowless leader-drains-queue
  combiner (the same design as the probe-launch batcher in bloom/bank.py):
  the leader launches the resident stream once with the UNION of pending
  queries' needles and every waiter slices out its blocks' chunk spans —
  so a query touching 40 pinned blocks costs ~1 launch, not 40 (each
  launch pays dispatch plus a device-to-host transfer).

Conservative-by-construction like scan.py: rows whose bytes can't prove
needle absence (non-ASCII, \\uXXXX / \\/ escapes) are always-candidates,
needles longer than MAX_NEEDLE fall back to always-candidate, and the exact
verification stage still runs on every candidate. Cross-row and
length-prefix bytes in the stream can only create false positives (rejected
by verification), never hide a true match.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import threading
import time
from typing import Optional

import numpy as np

from . import native as _native

logger = logging.getLogger("bloomsearch_tpu.rowcache")

# Stream chunk geometry: 512-byte physical rows (128 packed int32 words);
# the last MAX_NEEDLE bytes of each chunk duplicate the next chunk's head so
# windows never straddle a chunk.
CHUNK_BYTES = 512
MAX_NEEDLE = 32  # longer needles fall back to always-candidate
STREAM_STRIDE = CHUNK_BYTES - MAX_NEEDLE  # payload bytes per chunk (480)
# Per-needle bitmap cache entries (packed ~cap_chunks/8 bytes each). The
# byte cap dominates at large streams: a 10 GB stream's ~21M-chunk bitmaps
# are ~2.6 MB each, so 128 entries would silently hold ~340 MB of host RAM.
_NEEDLE_CACHE_MAX = 128
_NEEDLE_CACHE_MAX_BYTES = 32 << 20
# Sparse segment scans above this many (pow2-bucketed) segments fall back
# to dense scan-all: warmup precompiles exactly buckets {1, 2, 4} plus the
# dense program, so no query-time jit ever fires.
_SPARSE_MAX_SEGS = 4
# Stream growth increment once doubling would exceed this many bytes (the
# grow-copy holds old+new matrices concurrently in HBM).
_GROWTH_STEP_BYTES = 512 << 20
# Total seconds a background pin may spend paused at its yield points
# waiting for in-flight queries to drain. Bounded so a pin holding
# _upload_lock can never stall invalidate_file (merge tombstones) or other
# pins indefinitely under a saturating query stream.
_PIN_YIELD_MAX_S = 5.0


def _yield_point(yield_to, deadline: float, hurry=None) -> None:
    """Pause while ``yield_to()`` is truthy (queries in flight), up to
    ``deadline``. Background pins call this before each expensive device
    step so query probe/scan launches never queue behind multi-MB stream
    uploads or compaction gathers on the single device stream.

    ``hurry()`` truthy ends the pause immediately: a FOREGROUND caller
    (query-path sync pin, tombstone, shutdown) is blocked on _upload_lock
    — which this background holder owns — so sleeping "for the query"
    would be a priority inversion: the query can't finish precisely
    because we're waiting for it to finish."""
    if yield_to is None:
        return
    while time.monotonic() < deadline:
        if hurry is not None and hurry():
            return
        try:
            if not yield_to():
                return
        except Exception:
            return
        time.sleep(0.005)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _needle_buckets() -> tuple[int, ...]:
    """Dense-launch needle counts (pow2 up to MAX_SCAN_NEEDLES): each is its
    own compiled program, and warmup compiles them all."""
    from .stream_scan import MAX_SCAN_NEEDLES

    return tuple(1 << i for i in range(MAX_SCAN_NEEDLES.bit_length()))


def _unpack_bit_range(raw_u8: np.ndarray, start: int, n: int) -> np.ndarray:
    """bool[n] slice [start, start+n) of a little-endian packed bitmap.

    Unpacks ONLY the covering bytes: a needle query touches a few blocks'
    chunk spans, while the packed bitmap covers full residency (~18M bits
    at xlscale) — unpacking it whole cost milliseconds of host CPU per
    needle per launch on the warm-query critical path, worst for cached
    needles re-unpacked every query."""
    if n <= 0:
        return np.zeros(0, dtype=bool)
    b0 = start >> 3
    b1 = (start + n + 7) >> 3
    bits = np.unpackbits(raw_u8[b0:b1], bitorder="little")
    lo = start - (b0 << 3)
    return bits[lo : lo + n].astype(bool)


def _pack_stream_numpy(
    data: bytes, row_offsets: np.ndarray, row_lengths: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The semantic spec for native bs_pack_stream (bit-parity asserted in
    tests): lowered overlapped chunks + conservative always-candidate flags."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    lowered = np.where((buf >= 65) & (buf <= 90), buf + 32, buf).astype(np.uint8)
    n_chunks = -(-n // STREAM_STRIDE) if n else 0
    chunks = np.zeros((max(n_chunks, 1), CHUNK_BYTES), dtype=np.uint8)
    if n_chunks:
        padded = np.zeros(n_chunks * STREAM_STRIDE + MAX_NEEDLE, dtype=np.uint8)
        padded[:n] = lowered
        chunks[:n_chunks] = np.lib.stride_tricks.as_strided(
            padded, shape=(n_chunks, CHUNK_BYTES), strides=(STREAM_STRIDE, 1)
        )
    num_rows = row_offsets.shape[0]
    flags = np.zeros(num_rows, dtype=bool)
    if num_rows:
        off = row_offsets.astype(np.int64)
        ln = row_lengths.astype(np.int64)
        # Defensive: rows pointing outside the buffer conservatively include.
        bad = (off < 0) | (ln < 0) | (off + ln > n)
        if n:
            # Rows whose stored bytes cannot PROVE a needle's absence: raw
            # non-ASCII bytes (Unicode lowercase may be pure ASCII, e.g.
            # U+212A -> 'k') and \uXXXX / \/ escapes (may hide printable-
            # ASCII needle bytes; the pair's second byte is compared lowered
            # so "\\U" flags exactly like "\\u"). A per-byte pair test
            # over-approximates the escape-aware walk (a literal "\\u" also
            # flags) — conservative is correct here.
            nonascii = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(buf >= 0x80, out=nonascii[1:])
            nxt = np.empty_like(lowered)
            nxt[:-1] = lowered[1:]
            nxt[-1] = 0
            pair = (buf == ord("\\")) & ((nxt == ord("u")) | (nxt == ord("/")))
            pairs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(pair, out=pairs[1:])
            start = np.clip(off, 0, n)
            end = np.clip(off + ln, start, n)
            flags |= (nonascii[end] - nonascii[start]) > 0
            # Pairs must sit WITHIN the row: positions [off, off+len-2].
            pe = np.maximum(end - 1, start)
            flags |= (pairs[pe] - pairs[start]) > 0
        flags |= bad
    return chunks, flags


def pack_block(
    data, row_offsets: np.ndarray, row_lengths: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack one block's row buffer into serving-stream form.

    -> (chunks uint8[max(n_chunks,1), CHUNK_BYTES], always_candidate
    bool[num_rows], n_chunks). Pure function of the block bytes — what the
    restart sidecar (servingcache.py) persists; pin() calls it when the
    caller didn't supply ``prepacked``.
    """
    nat = (
        _native.pack_stream(
            data, row_offsets, row_lengths, STREAM_STRIDE, CHUNK_BYTES
        )
        if _native.available()
        else None
    )
    if nat is not None:
        # Native single pass: chunk + lowercase + conservative flags at
        # GB/s; _pack_stream_numpy is the spec (parity tested).
        chunks, flags = nat
        always_candidate = flags.astype(bool)
    else:
        chunks, always_candidate = _pack_stream_numpy(
            data, row_offsets, row_lengths
        )
    n_chunks = -(-len(data) // STREAM_STRIDE) if data is not None and len(data) else 0
    return chunks, always_candidate, n_chunks


def _device_scan_fn(mesh):
    import functools

    import jax
    import jax.numpy as jnp

    from .stream_scan import scan_stream

    # A start byte s counts iff it lies in the chunk's payload: s < STRIDE.
    valid_words = STREAM_STRIDE // 4

    @functools.partial(jax.jit, static_argnames=("impl", "n_real", "max_words"))
    def scan_all(rows32, needles_padded, needle_lens, *,
                 impl: str, n_real: int, max_words: int):
        """rows32 int32[G, 128] (lowercased overlapped stream chunks, bytes
        packed little-endian 4-per-word), needles int32[N, MAX_NEEDLE] byte
        values, lens int32[N] -> packed uint32[n_real, G/32] hit bitmap over
        EVERY resident chunk.

        Scan-all, not gather-then-scan: the full-residency bitmap is
        cacheable per needle, and the program compiles once per (cap, N
        bucket, word bucket), independent of which chunks a query asks
        for. On a mesh each device scans its own chunk shard
        (parallel.mesh.sharded_scan_all_rows — overlap bytes are duplicated
        into each chunk at pack time, so shard boundaries need no halo
        exchange).
        """
        if mesh is not None:
            from .parallel.mesh import sharded_scan_all_rows

            return sharded_scan_all_rows(
                mesh, rows32, needles_padded, needle_lens, impl=impl,
                n_real=n_real, max_words=max_words, valid_words=valid_words,
            )
        return scan_stream(
            rows32, needles_padded, needle_lens, impl=impl,
            n_real=n_real, max_words=max_words, valid_words=valid_words,
        )

    @functools.partial(
        jax.jit, static_argnames=("impl", "n_real", "max_words", "seg_chunks")
    )
    def scan_segments(rows32, seg_starts, needles_padded, needle_lens, *,
                      impl: str, n_real: int, max_words: int, seg_chunks: int):
        """Slice `len(seg_starts)` contiguous chunk ranges of seg_chunks
        each out of the stream and scan only those (with the same scan as
        scan_all) -> packed uint32[n_real, n_segs*seg_chunks/32].

        The sparse-request path: when a query's blocks cover a small
        fraction of residency (needle queries at reference scale ask for 3
        of 240 blocks), slicing whole segments with dynamic_slice is
        memory-bound — unlike row gathers — and scans + transfers orders
        of magnitude less than full residency. Single-device only (the
        mesh path always scans its shards in full).
        """
        parts = [
            jax.lax.dynamic_slice_in_dim(rows32, seg_starts[s], seg_chunks, axis=0)
            for s in range(seg_starts.shape[0])
        ]
        sub = jnp.concatenate(parts, axis=0)
        return scan_stream(
            sub, needles_padded, needle_lens, impl=impl,
            n_real=n_real, max_words=max_words, valid_words=valid_words,
        )

    if mesh is not None:
        from .parallel.mesh import serialized_launch

        scan_all = serialized_launch(scan_all)  # a mesh scan gathers across devices
    return scan_all, scan_segments


class _PinnedBlock:
    __slots__ = (
        "key", "num_chunks", "num_rows", "always_candidate",
        "nbytes", "host_nbytes", "data", "fetcher",
        "row_offsets", "row_lengths", "_row_ends",
    )

    def __init__(self, key, num_chunks, num_rows, always_candidate,
                 data, row_offsets, row_lengths, fetcher=None):
        # The block's chunk placement lives ONLY in the stream bucket's
        # segments map (snapshot under the cache lock) — never on the block
        # object, where an unsynchronized copy would go stale under
        # compaction.
        self.key = key
        self.num_chunks = num_chunks
        self.num_rows = num_rows
        self.always_candidate = always_candidate  # bool[num_rows]
        # Candidate extraction source — exactly one of the two:
        #  - data: host shadow of the decompressed block bytes;
        #  - fetcher(idx, offsets, lengths) -> (buffer, local_off, local_len):
        #    on-demand ranged re-read of candidate rows from the store
        #    (shadow-free serving drops the ~1.2x-of-raw host copy).
        self.data = data
        self.fetcher = fetcher
        self.row_offsets = row_offsets
        self.row_lengths = row_lengths
        self._row_ends = None  # lazy: row_offsets + row_lengths
        self.host_nbytes = (
            (len(data) if data is not None else 0)
            + row_offsets.nbytes
            + row_lengths.nbytes
            + (always_candidate.nbytes if hasattr(always_candidate, "nbytes") else 0)
        )
        self.nbytes = num_chunks * CHUNK_BYTES + self.host_nbytes

    def fetch_rows(self, idx) -> tuple:
        """-> (buffer, offsets, lengths) for the given row indices; offsets
        are local to the returned buffer."""
        return self.fetcher(idx, self.row_offsets, self.row_lengths)

    def row_ends(self) -> np.ndarray:
        if self._row_ends is None:
            self._row_ends = (
                self.row_offsets.astype(np.int64)
                + self.row_lengths.astype(np.int64)
            )
        return self._row_ends


def _expand_chunk_hits(
    block: _PinnedBlock, needle_len: int, chunk_bits: np.ndarray
) -> np.ndarray:
    """Chunk hit bits -> conservative bool[num_rows] candidates.

    A hit in chunk c is a match starting in its payload, so the matched
    span lies within bytes [c*STRIDE, c*STRIDE + STRIDE + len - 1); every
    row overlapping that range is a candidate (span-overlap marking, the
    host scanner's mark_rows rule at chunk granularity)."""
    out_rows = block.num_rows
    hc = np.flatnonzero(chunk_bits[: block.num_chunks])
    if hc.size == 0 or out_rows == 0:
        return np.zeros(out_rows, dtype=bool)
    starts = hc.astype(np.int64) * STREAM_STRIDE
    ends = starts + STREAM_STRIDE + needle_len - 1
    lo = np.searchsorted(block.row_ends(), starts, side="right")
    hi = np.searchsorted(block.row_offsets, ends, side="left")
    marks = np.zeros(out_rows + 1, dtype=np.int32)
    np.add.at(marks, lo, 1)
    np.add.at(marks, hi, -1)
    return np.cumsum(marks[:-1]) > 0


class _StreamBucket:
    """The shared stream matrix; blocks occupy contiguous chunk ranges."""

    __slots__ = (
        "matrix", "cap", "used", "dead", "segments",
        "pending", "launch_lock", "version", "needle_cache",
    )

    def __init__(self):
        # Packed chunk bytes, [cap, 128] int32; cap, used, dead, and
        # segment coordinates are all in CHUNKS.
        self.matrix = None
        self.cap = 0
        self.used = 0
        self.dead = 0
        self.segments: dict[tuple, tuple[int, int]] = {}  # key -> (start, n)
        # Cross-query scan combiner state (guarded by the cache lock /
        # launch_lock — see DeviceRowCache.scan).
        self.pending: list["_PendingScan"] = []
        self.launch_lock = threading.Lock()
        # Needle-bitmap cache: scan-all computes hits for EVERY resident
        # chunk, so a needle's packed bitmap stays valid until the matrix
        # changes. version bumps on every matrix reassignment; entries are
        # {needle: (version, packed uint32[cap/32])}, LRU-capped.
        self.version = 0
        self.needle_cache: dict[bytes, tuple[int, np.ndarray]] = {}


class _PendingScan:
    __slots__ = ("keys", "needles", "done", "hits", "segments", "error")

    def __init__(self, keys: list[tuple], needles: tuple[bytes, ...]):
        self.keys = keys
        self.needles = needles
        self.done = threading.Event()
        # key -> {needle: bool[num_chunks]} (None value: block vanished).
        self.hits: Optional[dict[tuple, Optional[dict]]] = None
        # Per-key (start, n) chunk coordinates in the SAME matrix snapshot
        # the hits came from — compaction may move chunks concurrently, so
        # slice coordinates must travel with the launch, not the blocks.
        self.segments: Optional[list[Optional[tuple[int, int]]]] = None
        self.error: Optional[BaseException] = None


class DeviceRowCache:
    """LRU cache of pinned blocks keyed by (file pointer, block offset)."""

    def __init__(
        self,
        capacity_bytes: int,
        mesh_devices: Optional[int] = None,
        host_shadow: bool = False,
    ):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self._jnp = jnp
        self.capacity_bytes = capacity_bytes
        # Shadowed pins keep the block's decompressed bytes host-side
        # (~0.94x their device chunk bytes), so the reservation must split
        # the byte budget between the stream and the shadows; shadow-free
        # pins retain only offset/length arrays (a few % of raw).
        self.host_shadow = bool(host_shadow)
        # Multi-device serving: the stream matrix shards its CHUNK axis over
        # a 1-D mesh (same auto policy as the filter superbanks) — pinned
        # capacity and scan compute scale linearly in devices.
        n_visible = len(jax.devices())
        want = n_visible if mesh_devices is None else mesh_devices
        if want > 1:
            # Same contract as DeviceProbeBackend: an explicit multi-device
            # request that can't be satisfied is an error, not a silent
            # single-device downgrade (capacity/scan scaling would vanish
            # without a trace).
            if n_visible < want:
                raise RuntimeError(
                    f"mesh_devices={want} but only {n_visible} device(s) visible"
                )
            from .parallel.mesh import default_mesh

            self.mesh = default_mesh(n_devices=want)
            # 512-chunk unit x even shard split: every local shard holds
            # whole scan tiles and whole bitmap words.
            self._chunk_unit = 512 * want
        else:
            self.mesh = None
            self._chunk_unit = 512
        self._lock = threading.Lock()
        # Serializes every MUTATION of the stream matrix (pin uploads,
        # growth copies, compaction) so the slow device work runs OUTSIDE
        # self._lock and concurrent scans never stall behind an upload.
        # Ordering: _upload_lock is always acquired BEFORE _lock, never
        # while holding it. Scans/readers take only _lock; segment state
        # mutates only under BOTH (briefly under _lock), so matrix +
        # segments snapshots taken under _lock alone stay consistent.
        self._upload_lock = threading.Lock()
        # Count of FOREGROUND threads (query-path sync pins, tombstones,
        # shutdown) currently blocked on _upload_lock: a background
        # holder's yield points consult it via _has_upload_waiters and
        # hurry instead of sleeping (see _yield_point's inversion note).
        self._upload_waiters = 0
        self._waiters_lock = threading.Lock()
        self._blocks: dict[tuple[bytes, int], _PinnedBlock] = {}
        self._bucket = _StreamBucket()
        # Shape floor set by reserve(): compaction never shrinks cap below
        # it and pins reclaim-in-place instead of growing past it, so the
        # stream matrix keeps ONE shape (= one set of compiled scan
        # programs) across arbitrary pin/evict churn.
        self._reserved_cap = 0
        self._scan, self._scan_segments = _device_scan_fn(self.mesh)
        from . import route

        # Which stream scan runs here (stream_scan.scan_stream's ``impl``).
        self.scan_impl = route.scan_impl(route.platform())
        # Version-keyed needle-bitmap cache (scan-all bitmaps outlive the
        # query that computed them); benchmarks disable this to measure the
        # uncached scan path.
        self.needle_cache_enabled = True
        self.launches = 0  # observability
        self.scan_requests = 0
        self.aot_failures = 0  # precompile shapes that failed to compile
        self.pins = 0        # blocks pinned (incl. re-pins after eviction)
        self.evictions = 0   # blocks evicted for capacity (not invalidation)
        self.compactions = 0 # stream compaction passes
        self._closed = False

    # -- residency ------------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes_locked()

    def stream_free_chunks(self) -> Optional[int]:
        """Chunks still pinnable without evicting, or None when no
        reservation fixes the capacity (warmup's pin pass stops here so a
        beyond-budget dataset doesn't churn the whole stream through
        evictions)."""
        if not self._reserved_cap:
            return None
        with self._lock:
            b = self._bucket
            return max(self._reserved_cap - (b.used - b.dead), 0)

    def stats(self) -> dict:
        """Public observability snapshot (the contract engine.stats() uses)."""
        with self._lock:
            device = self._bucket.cap * CHUNK_BYTES
            host = sum(blk.host_nbytes for blk in self._blocks.values())
            pinned = len(self._blocks)
        return {
            "bytes": device + host,
            "device_bytes": device,
            "host_bytes": host,
            "pinned_blocks": pinned,
            "scan_launches": self.launches,
            "scan_aot_failures": self.aot_failures,
            "scan_requests": self.scan_requests,
            "pins": self.pins,
            "evictions": self.evictions,
            "compactions": self.compactions,
            "mesh_devices": self.mesh.shape["blocks"] if self.mesh is not None else 1,
        }

    def _total_bytes_locked(self) -> int:
        bucket_bytes = self._bucket.cap * CHUNK_BYTES
        host_bytes = sum(blk.host_nbytes for blk in self._blocks.values())
        return bucket_bytes + host_bytes

    def get(self, key: tuple[bytes, int]) -> Optional[_PinnedBlock]:
        with self._lock:
            block = self._blocks.pop(key, None)
            if block is not None:
                self._blocks[key] = block  # LRU bump
            return block

    def _has_upload_waiters(self) -> bool:
        # Racy read by design: a stale False costs one 5 ms yield-sleep.
        return self._upload_waiters > 0

    @contextlib.contextmanager
    def _mutation_lock(self, foreground: bool = True):
        """_upload_lock acquisition that, for FOREGROUND callers, advertises
        the wait: a background pin holding the lock polls
        _has_upload_waiters at its yield points and hurries instead of
        sleeping on the very query its waiter is part of (priority
        inversion — the query can't drain while its pin blocks here)."""
        if foreground:
            with self._waiters_lock:
                self._upload_waiters += 1
        try:
            self._upload_lock.acquire()
        finally:
            if foreground:
                with self._waiters_lock:
                    self._upload_waiters -= 1
        try:
            yield
        finally:
            self._upload_lock.release()

    def release(self) -> None:
        """Free the stream's device memory NOW (engine shutdown).

        jax Arrays release HBM only when their last Python reference dies;
        engine/thread/closure cycles can keep a multi-GB stream alive well
        past stop() even across gc.collect() — observed as the NEXT engine
        in the same process failing its warmup pins with RESOURCE_EXHAUSTED.
        Explicit Array.delete() returns the HBM regardless of lingering
        references. Waits for in-flight mutations (_upload_lock); later
        pin()/reserve() raise, in-flight background pins fail and are
        swallowed by their callers' warmup error handling.
        """
        # launch_lock AFTER _mutation_lock, BEFORE _lock — the same order a
        # scan leader uses (launch_lock -> _lock), and no leader takes
        # _mutation_lock. Holding it here means no scan launch is mid-flight
        # when the matrix is deleted: a leader that snapshotted the matrix
        # earlier has finished, and later leaders see matrix None and
        # resolve via the vanished contract instead of crashing every
        # coalesced query on a deleted Array.
        with self._mutation_lock(), self._bucket.launch_lock:
            with self._lock:
                self._closed = True
                bucket = self._bucket
                matrix = bucket.matrix
                bucket.matrix = None
                bucket.cap = 0
                bucket.used = 0
                bucket.dead = 0
                bucket.segments = {}
                bucket.needle_cache.clear()
                bucket.version += 1
                self._blocks.clear()
                self._reserved_cap = 0
            if matrix is not None:
                try:
                    matrix.delete()
                except Exception:  # pragma: no cover - already deleted
                    logger.debug("stream matrix delete failed", exc_info=True)

    def invalidate_file(self, pointer: bytes) -> None:
        with self._mutation_lock():
            with self._lock:
                for key in [k for k in self._blocks if k[0] == pointer]:
                    self._remove_locked(key)
            self._maybe_compact()

    def _remove_locked(self, key) -> None:
        block = self._blocks.pop(key, None)
        if block is None:
            return
        seg = self._bucket.segments.pop(key, None)
        if seg is not None:
            # The block's whole chunk footprint becomes reclaimable.
            self._bucket.dead += seg[1]

    def reserve(self, total_chunks: int) -> int:
        """Pre-size the stream matrix so its SHAPE is final before pinning.

        Warmup calls this with the dataset's total chunk count (derivable
        from block metadata): scan programs then compile once on the final
        shape BEFORE the long pin pass, so queries arriving mid-warmup run
        warm-shaped programs, and later pin/evict churn never reshapes the
        matrix (compaction floors at the reservation; pins reclaim in place
        instead of growing past it). Capped at ~90% of the byte budget
        (shadow-free: host side is just offset/length arrays) or ~45% with
        the host shadow on — each pinned chunk then also costs ~0.94x its
        device bytes host-side, and a 90% device claim would leave pin()'s
        byte-budget eviction only ~10% of the budget for LIVE content (the
        stream never reaches its reservation, stream_free_chunks() stays
        large, and the churn rate-limiter silently never engages). Returns
        the reserved cap in chunks.
        """
        unit = self._chunk_unit
        # Budget cap rounds DOWN to the unit (rounding up could overshoot
        # the device byte budget); the dataset size rounds up.
        frac = 0.45 if self.host_shadow else 0.9
        budget_chunks = max(
            ((int(self.capacity_bytes * frac)) // CHUNK_BYTES // unit) * unit, unit
        )
        cap = min(_round_up(max(total_chunks, 1) + 512, unit), budget_chunks)
        with self._mutation_lock():
            if self._closed:
                raise RuntimeError("row cache released")
            bucket = self._bucket
            if cap <= bucket.cap:
                self._reserved_cap = max(self._reserved_cap, bucket.cap)
                return bucket.cap
            from .parallel.mesh import sharded_pad_rows, sharded_zeros_rows

            if bucket.matrix is None:
                matrix = sharded_zeros_rows(
                    self.mesh, cap, CHUNK_BYTES // 4, dtype=self._jnp.int32
                )
            else:
                matrix = sharded_pad_rows(self.mesh, bucket.matrix, cap)
            with self._lock:
                bucket.matrix = matrix
                bucket.cap = cap
                bucket.version += 1
                bucket.needle_cache.clear()
            self._reserved_cap = cap
        return cap

    def _maybe_compact(self, force: bool = False) -> None:
        """Compact dead chunk ranges out of the stream. Caller holds
        _upload_lock; the device gather runs WITHOUT self._lock (scans keep
        flowing against the old matrix snapshot) and the new layout
        publishes atomically under self._lock at the end. Segment state
        only mutates under _upload_lock, so the snapshot taken here cannot
        go stale before publish."""
        from .parallel.mesh import sharded_take_rows, sharded_zeros_rows

        jnp = self._jnp
        bucket = self._bucket
        with self._lock:
            if bucket.dead == 0 or (not force and bucket.dead * 2 < bucket.used):
                return
            order = sorted(bucket.segments.items(), key=lambda kv: kv[1][0])
            matrix = bucket.matrix
        cursor = 0
        new_segments = {}
        spans = []
        for key, (start, n) in order:
            spans.append((start, n))
            new_segments[key] = (cursor, n)
            cursor += n
        unit = self._chunk_unit
        # Never shrink below a reservation: shape stability is the contract.
        new_cap = max(
            unit, _round_up(max(cursor, 1), unit), self._reserved_cap
        )
        if cursor:
            idx = jnp.asarray(
                np.concatenate(
                    [np.arange(s, s + n, dtype=np.int32) for s, n in spans]
                )
            )
            new_matrix = sharded_take_rows(self.mesh, matrix, idx, new_cap)
        else:
            new_matrix = sharded_zeros_rows(
                self.mesh, new_cap, CHUNK_BYTES // 4, dtype=jnp.int32
            )
        with self._lock:
            bucket.matrix = new_matrix
            bucket.cap = new_cap
            bucket.used = cursor
            bucket.dead = 0
            bucket.segments = new_segments
            bucket.version += 1
            bucket.needle_cache.clear()
            self.compactions += 1

    def pin(
        self,
        key: tuple[bytes, int],
        data: bytes,
        row_offsets: np.ndarray,
        row_lengths: np.ndarray,
        fetcher=None,
        yield_to=None,
        prepacked: Optional[tuple[np.ndarray, np.ndarray, int]] = None,
    ) -> _PinnedBlock:
        """Chunk + lowercase a block's row buffer and append it to the
        stream matrix.

        With ``fetcher`` the block pins SHADOW-FREE: ``data`` feeds the
        device pack but is not retained host-side; candidate rows re-read
        through ``fetcher(idx, offsets, lengths)`` at extraction time
        (engine._fetch_pinned_rows — ranged store reads + chunk-granular
        snappy decode). Cuts serving host memory from ~1.2x raw to just the
        offset/length/flag arrays.

        The host pack and the device upload run under _upload_lock only —
        a cold pin's multi-MB h2d transfer must not stall concurrent warm
        scans, which take just self._lock. The new segment publishes
        atomically under self._lock once the upload lands.

        ``yield_to`` (background/warmup pins only — NEVER a query-path
        sync pin, which would deadlock on itself): a callable polled at
        each device-work boundary; while truthy the pin pauses (bounded by
        _PIN_YIELD_MAX_S total) so in-flight queries' launches aren't
        queued behind this pin's uploads/compactions on the device.

        ``prepacked`` = (chunks, always_candidate, n_chunks) from
        pack_block() or a restart sidecar (servingcache.py): the pack pass
        is skipped and ``data`` may be None (fetcher then required — there
        are no bytes to shadow)."""
        jnp = self._jnp
        num_rows = row_offsets.shape[0]
        with self._lock:
            existing = self._blocks.get(key)
            if existing is not None:
                return existing

        if prepacked is not None:
            chunks, always_candidate, n_chunks = prepacked
            if data is None and fetcher is None:
                raise ValueError("prepacked pin without data requires a fetcher")
        else:
            chunks, always_candidate, n_chunks = pack_block(
                data, row_offsets, row_lengths
            )

        # Pack 4 bytes per int32 word, little-endian (what the SWAR scan
        # and its pattern words assume). A pure
        # reinterpret on little-endian hosts.
        if sys.byteorder == "little":
            packed = chunks.view(np.int32)
        else:
            m32 = chunks.reshape(chunks.shape[0], -1, 4).astype(np.uint32)
            packed = (
                m32[..., 0] | (m32[..., 1] << 8) | (m32[..., 2] << 16) | (m32[..., 3] << 24)
            ).view(np.int32)

        deadline = time.monotonic() + _PIN_YIELD_MAX_S
        hurry = self._has_upload_waiters
        _yield_point(yield_to, deadline, hurry)
        # A query-path sync pin (yield_to None) is a foreground waiter: it
        # advertises itself so a background holder's yield points hurry.
        with self._mutation_lock(foreground=yield_to is None):
            # Restart the yield allowance now that the lock is HELD: waiting
            # behind another pin's multi-second piecewise upload (or the
            # pre-lock yield above) must not consume it, or this pin's own
            # h2d pieces and compaction gather run yield-exhausted and queue
            # multi-MB device work ahead of in-flight queries — the exact
            # mid-warmup latency spike the yield points exist to prevent.
            deadline = time.monotonic() + _PIN_YIELD_MAX_S
            with self._lock:
                if self._closed:
                    raise RuntimeError("row cache released")
                existing = self._blocks.get(key)
                if existing is not None:
                    return existing

            from .parallel.mesh import (
                sharded_pad_rows,
                sharded_update_rows,
                sharded_update_rows_donated,
                sharded_zeros_rows,
            )

            # Matrix/used/cap mutate only under _upload_lock (held), so the
            # device work below runs against a stable base without _lock.
            bucket = self._bucket
            unit = self._chunk_unit
            matrix = bucket.matrix
            cap = bucket.cap
            used = bucket.used
            # True once ``matrix`` is a chain intermediate only this pin
            # references (growth copy or a post-first update output) —
            # donation is then safe and the update aliases in place
            # instead of copying the whole stream.
            matrix_private = False
            # Upload decomposes into pow2 pieces (below), whose zero-padded
            # tail may extend into not-yet-used space — size capacity for it.
            n_upload = _round_up(n_chunks, 512)
            if used + n_upload > cap:
                with self._lock:
                    at_budget = (
                        self._total_bytes_locked() >= self.capacity_bytes
                    )
            else:
                at_budget = False
            if used + n_upload > cap and (
                (self._reserved_cap and cap >= self._reserved_cap)
                or at_budget
            ):
                # Stream at reserved capacity — or, without a reserve(), at
                # the byte budget: reclaim in place instead of growing
                # (reserved: growth would reshape the matrix and invalidate
                # every compiled scan program; unreserved: eviction keeps
                # LIVE chunks under budget but compaction only fires at
                # dead*2 >= used, so growth-past-budget would let the
                # PHYSICAL matrix reach ~2x capacity_bytes and OOM a device
                # sized to the budget). Evict LRU blocks until the LIVE
                # chunks fit, then force-compact — the matrix keeps its
                # shape, only its contents rearrange. This is the steady
                # state of beyond-HBM serving (dataset > row_cache_bytes).
                # Evict with SLACK (cap/8, at least this pin): compaction is
                # a full-stream device gather, and freeing only n_upload
                # would re-trigger it on every subsequent at-capacity pin —
                # the slack lets ~cap/8 of fresh pins append compaction-free.
                #
                # Freeze the shape here: without this floor an unreserved
                # stream's force-compact would shrink cap to live size and
                # the re-check below would immediately grow it back — two
                # full-matrix copies and a scan-program reshape per
                # at-capacity pin.
                self._reserved_cap = max(self._reserved_cap, cap)
                _yield_point(yield_to, deadline, hurry)
                target = max(n_upload, cap // 8)
                with self._lock:
                    for oldest in list(self._blocks):
                        if (bucket.used - bucket.dead) + target <= cap:
                            break
                        if oldest == key:
                            continue
                        self._remove_locked(oldest)
                        self.evictions += 1
                self._maybe_compact(force=True)
                matrix = bucket.matrix
                cap = bucket.cap
                used = bucket.used
            if used + n_upload > cap:
                # Growth: double while small, then bounded increments — the
                # copy in sharded_pad_rows holds old+new concurrently, and
                # unbounded doubling at multi-GB stream sizes OOMs HBM.
                grow = min(cap, max(_GROWTH_STEP_BYTES // CHUNK_BYTES, 1))
                # Never grow the PHYSICAL matrix past the byte budget
                # unless this single pin genuinely needs more: doubling
                # overshoot otherwise parks cap at up to ~2x capacity_bytes
                # (eviction bounds LIVE chunks, not allocation) and OOMs a
                # device sized to the budget.
                with self._lock:
                    host_bytes = sum(
                        blk.host_nbytes for blk in self._blocks.values()
                    )
                budget_cap = (
                    max(self.capacity_bytes - host_bytes, 0)
                    // CHUNK_BYTES
                    // unit
                ) * unit
                need = _round_up(used + n_upload, unit)
                cap = max(
                    min(
                        max(need, _round_up(cap + grow, unit)),
                        max(budget_cap, need),
                    ),
                    unit,
                )
                if matrix is None:
                    matrix = sharded_zeros_rows(
                        self.mesh, cap, CHUNK_BYTES // 4, dtype=jnp.int32
                    )
                else:
                    matrix = sharded_pad_rows(self.mesh, matrix, cap)
                matrix_private = True
            if n_chunks > 0:
                # Piecewise pow2 upload: the update program compiles per
                # update SHAPE, and one compile per distinct block size
                # would dominate a reference-scale warmup (240 blocks).
                # Greedy pow2 pieces >= 512 chunks bound the shape set to
                # ~6 programs ever; the final piece zero-pads into
                # not-yet-used space (never part of any live segment, and
                # overwritten by the next pin's real bytes).
                off = 0
                while off < n_chunks:
                    if off:
                        _yield_point(yield_to, deadline, hurry)
                    remaining = n_chunks - off
                    piece = 512
                    while piece * 2 <= remaining:
                        piece *= 2
                    sub = packed[off : off + piece]
                    if sub.shape[0] < piece:
                        sub = np.concatenate(
                            [
                                sub,
                                np.zeros(
                                    (piece - sub.shape[0], CHUNK_BYTES // 4),
                                    dtype=np.int32,
                                ),
                            ]
                        )
                    # First piece against the PUBLISHED matrix must copy
                    # (concurrent scans hold that snapshot); every later
                    # piece (and any growth copy) is private to this pin
                    # and updates in place via donation — one stream copy
                    # per pin instead of one per piece, and the transient
                    # HBM peak stays at old+new regardless of piece count.
                    update = (
                        sharded_update_rows_donated
                        if matrix_private
                        else sharded_update_rows
                    )
                    matrix = update(
                        self.mesh, matrix, jnp.asarray(sub), jnp.int32(used + off)
                    )
                    matrix_private = True
                    off += piece

            # Retained coordinate arrays downcast to int32 (a block is at
            # most max_row_group_bytes, far under 2^31) — with the shadow
            # gone these arrays ARE the host footprint.
            if data is None or len(data) < (1 << 31):
                row_offsets = np.asarray(row_offsets, dtype=np.int32)
                row_lengths = np.asarray(row_lengths, dtype=np.int32)
            block = _PinnedBlock(
                key, n_chunks, num_rows, always_candidate,
                None if fetcher is not None else data,
                row_offsets, row_lengths, fetcher=fetcher,
            )
            with self._lock:
                bucket.matrix = matrix
                bucket.cap = cap
                if n_chunks > 0:
                    bucket.version += 1
                    bucket.needle_cache.clear()
                bucket.segments[key] = (used, n_chunks)
                bucket.used = used + n_chunks
                self._blocks[key] = block
                # LRU eviction under the byte budget. _remove_locked only
                # turns device chunks DEAD (compaction reclaims them after),
                # so budget against the post-compaction footprint — counting
                # dead chunks would evict the whole warm cache down to one
                # block whenever the device term alone exceeded the budget
                # (e.g. right after a growth step overshoots).
                while (
                    self._total_bytes_locked() - self._bucket.dead * CHUNK_BYTES
                    > self.capacity_bytes
                    and len(self._blocks) > 1
                ):
                    oldest = next(iter(self._blocks))
                    if oldest == key:
                        break
                    self._remove_locked(oldest)
                    self.evictions += 1
            self.pins += 1
            with self._lock:
                will_compact = bucket.dead > 0 and bucket.dead * 2 >= bucket.used
            if will_compact:
                _yield_point(yield_to, deadline, hurry)
            self._maybe_compact()
        return block

    # -- scanning ---------------------------------------------------------

    def precompile_scan_programs(self, blocks: list, yield_to=None) -> int:
        """AOT-compile (.lower().compile()) every scan program shape the
        warmup execution pass will run, WITHOUT touching the launch lock or
        the pending queue.

        ``yield_to``: optional callable invoked between programs — lowering
        is host work that starves a concurrent query's host path on
        few-core machines (the engine passes its queries-in-flight gate).

        Compiles held the scan launch lock for their full multi-second
        duration, so a query arriving mid-warmup starved behind them. AOT
        populates jax's
        persistent compilation cache first — the locked warm executions
        that follow (and any query-path launch) then deserialize instead of
        compiling. Shape enumeration
        mirrors _launch_bucket_scan: dense scan-all at every
        _needle_buckets() n_real per word bucket; sparse scan_segments
        (single-device only) at n_segs {1,2,4} with the needle axis at its
        fixed sparse capacity (MAX_SCAN_NEEDLES) and
        seg_chunks derived from ``blocks`` exactly like a live launch.
        A failed shape is counted in ``aot_failures`` and logged, then
        skipped (the execution pass still compiles it, just under the
        lock). Returns programs compiled.
        """
        bucket = self._bucket
        with self._lock:
            matrix = bucket.matrix
        if matrix is None:
            return 0
        from .stream_scan import MAX_SCAN_NEEDLES, SCAN_WORD_BUCKETS

        phys_cap = int(matrix.shape[0])
        max_chunks = max((b.num_chunks for b in blocks), default=1)
        seg_chunks = max(_round_up_pow2(max(max_chunks, 1)), 512)
        jnp = self._jnp
        compiled = 0
        for wb in SCAN_WORD_BUCKETS:
            padded = jnp.zeros((MAX_SCAN_NEEDLES, MAX_NEEDLE), jnp.int32)
            lens = jnp.zeros(MAX_SCAN_NEEDLES, jnp.int32)
            for n_bucket in _needle_buckets():
                common = dict(n_real=n_bucket, max_words=wb, impl=self.scan_impl)
                if yield_to is not None:
                    yield_to()
                try:
                    self._scan.lower(matrix, padded, lens, **common).compile()
                    compiled += 1
                except Exception:
                    self.aot_failures += 1
                    logger.warning("scan AOT failed (dense %s)", common,
                                   exc_info=True)
                if (
                    self.mesh is None
                    and n_bucket == MAX_SCAN_NEEDLES
                    and seg_chunks <= phys_cap
                ):
                    for n_segs in (1, 2, 4):
                        if n_segs * seg_chunks * 4 > phys_cap:
                            continue
                        starts = jnp.zeros(n_segs, jnp.int32)
                        if yield_to is not None:
                            yield_to()
                        try:
                            self._scan_segments.lower(
                                matrix, starts, padded, lens,
                                seg_chunks=seg_chunks, **common,
                            ).compile()
                            compiled += 1
                        except Exception:
                            self.aot_failures += 1
                            logger.warning(
                                "scan AOT failed (sparse %d)", n_segs,
                                exc_info=True,
                            )
        return compiled

    def scan(self, block: _PinnedBlock, needles: list[bytes]) -> np.ndarray:
        """-> bool[len(needles), num_rows] candidate matrix (device scan).

        Concurrent scans coalesce: one leader launches the stream ONCE with
        the union of pending needle sets and every waiter slices its own
        blocks' chunk spans."""
        return self.scan_many([block], needles)[block.key]

    def scan_many(
        self, blocks: list[_PinnedBlock], needles: list[bytes]
    ) -> dict[tuple, np.ndarray]:
        """Scan MANY pinned blocks in (at most) one launch.

        The query planner knows every surviving block upfront, so a warm
        serving-mode query costs ~one scan launch total instead of one per
        block. -> {block.key: bool[len(needles), num_rows]}.
        """
        out: dict[tuple, np.ndarray] = {}
        usable = tuple(n for n in needles if n and len(n) <= MAX_NEEDLE)
        hits = (
            self._bucket_hits([b.key for b in blocks], usable)
            if usable and blocks
            else {}
        )
        for block in blocks:
            mat = np.zeros((len(needles), block.num_rows), dtype=bool)
            block_hits = hits.get(block.key) if usable else {}
            stale = usable and (
                block_hits is None
                or any(h.shape[0] < block.num_chunks for h in block_hits.values())
            )
            if stale:
                # Evicted/moved under us: conservative (exact verify
                # still rejects false positives).
                mat[:] = True
            else:
                for qi, needle in enumerate(needles):
                    if not needle or len(needle) > MAX_NEEDLE:
                        mat[qi] = True  # degenerate/oversized
                    elif block_hits:
                        mat[qi] = _expand_chunk_hits(
                            block, len(needle), block_hits[needle]
                        )
            if block.always_candidate.any():
                mat[:, block.always_candidate[: block.num_rows]] = True
            out[block.key] = mat
        return out

    def _bucket_hits(
        self, keys: list[tuple], needles: tuple[bytes, ...]
    ) -> dict[tuple, Optional[dict]]:
        """Scan blocks via the combiner ->
        {key: {needle: bool[num_chunks]} | None (block vanished)}."""
        req = _PendingScan(keys, needles)
        bucket = self._bucket
        with self._lock:
            if bucket.matrix is None:
                return {k: None for k in keys}
            bucket.pending.append(req)
        with bucket.launch_lock:
            if not req.done.is_set():
                with self._lock:
                    batch = bucket.pending
                    bucket.pending = []
                    # Consistent snapshot: the matrix AND every waiter's
                    # segment coordinates under one lock acquisition
                    # (compaction may move chunks at any time).
                    matrix = bucket.matrix
                    version = bucket.version
                    for r in batch:
                        r.segments = [bucket.segments.get(k) for k in r.keys]
                if matrix is None:
                    # release() raced between this request's matrix check
                    # and leadership: resolve everyone with the vanished
                    # contract (None hits -> conservative all-candidates)
                    # instead of crashing the queries on a deleted matrix.
                    for r in batch:
                        r.hits = {k: None for k in r.keys}
                        r.done.set()
                else:
                    try:
                        self._launch_bucket_scan(bucket, matrix, version, batch)
                    except BaseException as exc:
                        for r in batch:
                            r.error = exc
                            r.done.set()
                        raise
        if req.error is not None:
            raise req.error
        return req.hits

    def _launch_bucket_scan(
        self, bucket: _StreamBucket, matrix, version: int,
        batch: list[_PendingScan],
    ) -> None:
        """ONE launch for every pending request: scan the stream matrix
        (all of it, or just the requested chunk segments when they're a
        small fraction of residency) against the union of the requested
        needles; each waiter slices its blocks' chunk spans out of the
        result bitmap."""
        jnp = self._jnp
        self.scan_requests += len(batch)
        union: list[bytes] = []
        seen = set()
        for r in batch:
            for n in r.needles:
                if n not in seen:
                    seen.add(n)
                    union.append(n)

        # Needle-bitmap cache: a scan-all bitmap covers every resident
        # chunk, so it stays valid as long as the matrix does
        # (version-checked). Repeated needles — dashboards, retried
        # queries — skip the device round-trip entirely.
        cached: dict[bytes, np.ndarray] = {}
        if self.needle_cache_enabled:
            with self._lock:
                for nd in union:
                    ent = bucket.needle_cache.pop(nd, None)
                    if ent is None:
                        continue
                    # Re-insert on hit: eviction pops the front, so a hit
                    # must refresh recency (LRU, not FIFO — a hot dashboard
                    # needle must survive a sweep of one-shot needles).
                    bucket.needle_cache[nd] = ent
                    if ent[0] == version:
                        cached[nd] = ent[1]
        missing = [nd for nd in union if nd not in cached]

        # Adaptive scan shape for needles not served from cache:
        #  - DENSE (requests cover a meaningful fraction of residency, or a
        #    mesh shards the stream): scan EVERY resident chunk; the
        #    full-residency bitmap also feeds the needle cache.
        #  - SPARSE (few blocks of a big stream — needle queries at
        #    reference scale ask for 3 of 240): dynamic-slice just the
        #    requested chunk segments on-device and scan those; both the
        #    scanned bytes and the returned bitmap shrink by the sparsity
        #    factor.
        from .stream_scan import MAX_SCAN_NEEDLES, scan_word_bucket

        phys_cap = int(matrix.shape[0])
        # Unique requested chunk ranges (chunk_start, n_chunks).
        ranges = sorted(
            {
                seg
                for r in batch
                for seg in r.segments
                if seg is not None and seg[1] > 0
            }
        )
        seg_chunks = _round_up_pow2(max((n for _, n in ranges), default=1))
        seg_chunks = max(seg_chunks, 512)  # the chunk unit
        # Segment-count buckets (1/2/4): the slice program unrolls one
        # dynamic_slice per segment, so each distinct count would otherwise
        # be its own multi-second jit compile; padding duplicates segment 0
        # (a few % extra scan). The count is CLAMPED at 4 — warmup
        # precompiles exactly buckets {1, 2, 4}, so no query shape ever
        # jits at query time: single needle queries (1-4 blocks) stay
        # sparse, and bursts of coalesced concurrent requests fall through
        # to the always-compiled dense scan-all instead of compiling a
        # fresh scan_segments shape at query time.
        n_segs = _round_up_pow2(len(ranges)) if ranges else 0
        sparse = (
            self.mesh is None
            and 0 < n_segs <= _SPARSE_MAX_SEGS
            and seg_chunks <= phys_cap
            and n_segs * seg_chunks * 4 <= phys_cap
        )
        if sparse:
            # Clamped slice starts; each range sits at a fixed offset
            # inside its part of the concatenated sub-matrix.
            starts = np.zeros(n_segs, dtype=np.int32)
            part_off: dict[tuple[int, int], tuple[int, int]] = {}
            for p, (ps, pn) in enumerate(ranges):
                cl = min(ps, phys_cap - seg_chunks)
                starts[p] = cl
                part_off[(ps, pn)] = (p, ps - cl)
            starts_dev = jnp.asarray(starts)
        logical_chunks = n_segs * seg_chunks if sparse else phys_cap

        chunk = MAX_SCAN_NEEDLES
        fresh: dict[bytes, np.ndarray] = {}
        if missing:
            # Sort by length before chunking: each launch's word-loop bound
            # is its LONGEST needle, so grouping similar lengths keeps a
            # short-needle launch from paying a long needle's word bucket
            # (the scan's integer work grows with the word count).
            missing.sort(key=len)
            for base in range(0, len(missing), chunk):
                part = missing[base : base + chunk]
                max_words = scan_word_bucket(max(len(n) for n in part))
                # One needle-array shape per launch; n_real (static) picks
                # how many rows the program scans.
                padded = np.zeros((MAX_SCAN_NEEDLES, MAX_NEEDLE), dtype=np.int32)
                lens = np.zeros(MAX_SCAN_NEEDLES, dtype=np.int32)
                for row, needle in enumerate(part):
                    padded[row, : len(needle)] = np.frombuffer(needle, dtype=np.uint8)
                    lens[row] = len(needle)
                # n_real is a static of the scan program, and every distinct
                # needle count would be its own compile (a coalesced burst's
                # odd-sized union would jit at query time). Padded rows carry zero masks — they match
                # everywhere and are sliced off below. SPARSE launches scan
                # so few bytes that the scan's per-needle cost is
                # negligible, so they always use the full needle capacity —
                # ONE program shape, exactly what warmup compiles. DENSE
                # launches pay real scan time per needle row, so they use
                # pow2 buckets (warmup compiles every _needle_buckets()).
                common = dict(
                    n_real=(
                        MAX_SCAN_NEEDLES if sparse else _round_up_pow2(len(part))
                    ),
                    max_words=max_words,
                    impl=self.scan_impl,
                )
                self.launches += 1  # one per DEVICE launch, not per pass
                if sparse:
                    packed = np.asarray(
                        self._scan_segments(
                            matrix, starts_dev,
                            jnp.asarray(padded), jnp.asarray(lens),
                            seg_chunks=seg_chunks, **common,
                        )
                    )
                else:
                    packed = np.asarray(
                        self._scan(
                            matrix, jnp.asarray(padded), jnp.asarray(lens), **common
                        )
                    )
                for row, needle in enumerate(part):
                    fresh[needle] = packed[row]
            # Only full-residency bitmaps are cacheable.
            if self.needle_cache_enabled and not sparse:
                with self._lock:
                    if bucket.version == version:
                        for needle, row in fresh.items():
                            # own copy: a view would pin the whole launch
                            # result array in memory
                            bucket.needle_cache[needle] = (
                                version, np.ascontiguousarray(row),
                            )
                        per_entry = max(
                            (ent[1].nbytes for ent in bucket.needle_cache.values()),
                            default=0,
                        )
                        max_entries = min(
                            _NEEDLE_CACHE_MAX,
                            _NEEDLE_CACHE_MAX_BYTES // per_entry if per_entry else _NEEDLE_CACHE_MAX,
                        )
                        while len(bucket.needle_cache) > max(max_entries, 1):
                            bucket.needle_cache.pop(next(iter(bucket.needle_cache)))

        # needle -> (full-residency coordinates?, PACKED bytes). Waiters
        # unpack only their blocks' bit ranges (_unpack_bit_range) — never
        # the full bitmap.
        bits: dict[bytes, tuple[bool, np.ndarray]] = {}
        for nd in union:
            full = nd in cached
            raw = cached[nd] if full else fresh[nd]
            bits[nd] = (
                full or not sparse,
                np.ascontiguousarray(raw).view(np.uint8),
            )
        for r in batch:
            hits: dict[tuple, Optional[dict]] = {}
            for key, seg in zip(r.keys, r.segments):
                if seg is None:
                    hits[key] = None
                    continue
                start, n = seg
                per_needle = {}
                for needle in r.needles:
                    full_coords, raw_u8 = bits[needle]
                    if full_coords or n == 0:
                        per_needle[needle] = _unpack_bit_range(raw_u8, start, n)
                    else:
                        p, off = part_off[(start, n)]
                        base = p * seg_chunks + off
                        per_needle[needle] = _unpack_bit_range(raw_u8, base, n)
                hits[key] = per_needle
            r.hits = hits
            r.done.set()
