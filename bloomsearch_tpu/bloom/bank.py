"""HBM-resident filter superbanks and the device probe backend.

The device-resident replacement for the reference's per-block filter reads
(file_format.go:121-142 + bloom_tree_engine.go:1104-1118): every resident
file's block filters live packed in a per-(m, k) device **superbank**
``uint32[3, num_words, capacity]``. A query probes *all* resident blocks of a
param group in one kernel launch and slices per-file results out of the
match matrix host-side. Files are immutable, so a bank column never changes —
inserts append, tombstones mark columns dead, and compaction rebuilds when
the dead fraction grows.

Capacity is padded to a multiple of 128 columns (whole bitmap words per
shard, 512-byte-aligned bank rows) and grows by doubling; zero-filled
columns can never produce a bloom match, so padding and dead columns are
inherently masked.

Device→host traffic is kept minimal: the [T, C] match matrix produced by the
probe program never leaves the device raw — it is packed to bitmap words
on-device (32x smaller) before the single small transfer per query.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger("bloomsearch_tpu.bank")

COL_UNIT = 128


class BackendReleasedError(RuntimeError):
    """Raised when a (background) bank load races engine shutdown past
    DeviceProbeBackend.release(): inserting after release would allocate
    device memory owned by a dead engine's backend — the HBM leak
    release() exists to prevent. Query paths never see this (the engine
    drains queries before releasing); warm/warmup paths catch it and
    stop quietly."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_terms(n: int) -> int:
    """Bucket the term count to limit jit recompiles."""
    p = 1
    while p < n:
        p *= 2
    return p


# Combined-launch caps: the probe combiner drains at most this many members
# / total terms / total CNF clauses per launch so coalesced bursts never
# exceed the program shapes engine.warmup() precompiles (Tp/Cp/Mp 16);
# undrained requests lead the next launch. A SINGLE request above a cap is
# split / host-evaluated (see _probe_superbank_batched) so even oversized
# queries stay inside the warmed shape set.
_PROBE_BATCH_MAX_MEMBERS = 16
_PROBE_BATCH_MAX_TERMS = 16
# Clause cap is its own constant (even while equal to the term cap): the
# drained CNF clause total must stay inside the warmed Cp=16 program shape
# independently of any retuning of the term cap.
_PROBE_BATCH_MAX_CLAUSES = 16


# Column-staging piece size: one bank-group insert would otherwise upload its
# whole flat array in a single h2d (54 MB per file group at reference scale),
# and a mid-warmup query's transfers queue behind it. Pieces bound the
# un-preemptible transfer; uniform piece widths bound the program set.
_STAGE_PIECE_BYTES = 8 << 20
# Total seconds one stage() may spend paused at yield points.
_STAGE_YIELD_MAX_S = 20.0


@functools.lru_cache(maxsize=None)
def _stage_fns():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("rows", "cols"))
    def zeros(rows: int, cols: int):
        return jnp.zeros((rows, cols), jnp.uint32)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def piece(staged, sub, off):
        # `staged` is always a private chain intermediate — donation
        # updates in place instead of copying the whole staging buffer.
        return jax.lax.dynamic_update_slice(staged, sub, (jnp.int32(0), off))

    return zeros, piece


def _stage_yield(yield_to, deadline: float) -> None:
    # Same contract as rowcache._yield_point: a gate callable that raises
    # must not abort a bank stage mid-upload (a background warm would
    # surface a spurious error) — stop yielding and proceed instead.
    while yield_to is not None and time.monotonic() < deadline:
        try:
            if not yield_to():
                return
        except Exception:
            return
        time.sleep(0.005)


class Superbank:
    """One device-resident bank for a (m_bits, k, layout) bloom param group.

    Layout is the probe's 2D layout: ``bank2d uint32[rows, capacity]``
    with row = keyspace*num_words + word (rows = 3 * num_words) and capacity
    padded to a multiple of COL_UNIT.

    With a ``mesh``, ``bank2d`` shards over the block axis
    (``P(None, "blocks")``): capacity pads to COL_UNIT × mesh size so shards
    split evenly, every maintenance op preserves the sharding
    (parallel/mesh.py), and filter capacity scales linearly in devices — the
    engine's answer to banks larger than one device's HBM (SURVEY.md §5
    "long-context analog").
    """

    def __init__(self, m_bits: int, k: int, layout: str, jnp, jax, mesh=None):
        self.m_bits = m_bits
        self.k = k
        self.layout = layout
        self.num_words = (m_bits + 31) // 32
        self.num_rows = 3 * self.num_words
        self._jnp = jnp
        self._jax = jax
        self.mesh = mesh
        # Shards must split the column units evenly across devices.
        self.col_unit = COL_UNIT * (mesh.shape["blocks"] if mesh is not None else 1)
        self.capacity = 0
        self.used = 0
        self.dead = 0
        self.bank2d = None  # jax uint32[num_rows, capacity]
        # key -> (start, num_cols); insertion order preserved for compaction.
        self.segments: dict[bytes, tuple[int, int]] = {}

    @property
    def nbytes(self) -> int:
        return self.num_rows * self.capacity * 4

    def _grow(self, min_capacity: int) -> None:
        from ..parallel.mesh import sharded_pad_columns, sharded_zeros

        new_cap = max(
            _round_up(min_capacity, self.col_unit), max(self.col_unit, self.capacity * 2)
        )
        if self.bank2d is None:
            self.bank2d = sharded_zeros(self.mesh, self.num_rows, new_cap)
        else:
            self.bank2d = sharded_pad_columns(self.mesh, self.bank2d, new_cap)
        self.capacity = new_cap

    def stage(self, host_bank: np.ndarray, yield_to=None):
        """Device-stage a group's columns OUTSIDE the backend lock.

        Uploads the flat [3*num_words, B] array in greedy-pow2 column
        pieces of ~8 MB with a ``yield_to`` poll between pieces (truthy
        while queries are in flight), so a query's result fetches never
        queue behind one long h2d transfer. The staged
        array is private to the caller; ``insert(..., staged=...)``
        publishes it with a single on-device update. Small groups return
        a direct single-transfer array (no staging overhead).
        """
        jnp = self._jnp
        _, w, num_cols = host_bank.shape
        assert w == self.num_words, (w, self.num_words)
        flat = np.ascontiguousarray(
            host_bank.reshape(3 * self.num_words, num_cols), dtype=np.uint32
        )
        col_bytes = flat.shape[0] * 4
        max_piece = 1
        while max_piece * 2 * col_bytes <= _STAGE_PIECE_BYTES:
            max_piece *= 2
        if num_cols <= max_piece:
            return jnp.asarray(flat)
        zeros, piece_fn = _stage_fns()
        # UNIFORM max_piece pieces into a max_piece-aligned staged buffer:
        # the piece program then has ONE shape per rows-family (the staged
        # width is a jit static too, so a max_piece-multiple bucket bounds
        # the zeros programs as well). Greedy pow2 tails compiled a fresh
        # program set per DISTINCT group width — merge-produced datasets
        # with heterogeneous block counts paid ~8 compiles each.
        # The zero-padded tail columns never join a segment (insert's
        # update may write them past `used`; the next insert overwrites).
        width = _round_up(num_cols, max_piece)
        staged = zeros(flat.shape[0], width)
        deadline = time.monotonic() + _STAGE_YIELD_MAX_S
        off = 0
        while off < num_cols:
            if off:
                _stage_yield(yield_to, deadline)
            sub = np.ascontiguousarray(flat[:, off : off + max_piece])
            if sub.shape[1] < max_piece:
                sub = np.concatenate(
                    [
                        sub,
                        np.zeros(
                            (sub.shape[0], max_piece - sub.shape[1]),
                            dtype=np.uint32,
                        ),
                    ],
                    axis=1,
                )
            staged = piece_fn(staged, jnp.asarray(sub), self._jnp.int32(off))
            off += max_piece
        return staged

    def insert(
        self, key: bytes, host_bank: np.ndarray, staged=None
    ) -> tuple[int, int]:
        """Append a file-group's bank uint32[3, num_words, B] -> (start, B)."""
        from ..parallel.mesh import sharded_update_columns

        assert key not in self.segments
        _, w, num_cols = host_bank.shape
        assert w == self.num_words, (w, self.num_words)
        jnp = self._jnp
        # stage() may hand back a max_piece-aligned buffer wider than the
        # group (shape-bucketed uploads): the zero tail writes past `used`
        # into unclaimed capacity — never part of any segment, overwritten
        # by the next insert. Narrower than the group means a stale/foreign
        # staged array: rebuild directly.
        if staged is None or staged.shape[1] < num_cols:
            flat = host_bank.reshape(3 * self.num_words, num_cols)
            staged = jnp.asarray(flat, dtype=jnp.uint32)
        if self.used + staged.shape[1] > self.capacity:
            self._grow(self.used + staged.shape[1])
        self.bank2d = sharded_update_columns(
            self.mesh,
            self.bank2d,
            staged,
            jnp.int32(self.used),
        )
        segment = (self.used, num_cols)
        self.segments[key] = segment
        self.used += num_cols
        return segment

    def remove(self, key: bytes) -> None:
        segment = self.segments.pop(key, None)
        if segment is not None:
            self.dead += segment[1]

    def maybe_compact(self, force: bool = False) -> None:
        """Rebuild without dead columns once they dominate (``force``: any
        dead column compacts — the backend uses it when live segments fit
        the byte budget but the dead slack holds real HBM past it)."""
        from ..parallel.mesh import sharded_take_columns, sharded_zeros

        if self.dead == 0 or (not force and self.dead * 2 < self.used):
            return
        jnp = self._jnp
        live_keys = list(self.segments)
        cols = []
        new_segments: dict[bytes, tuple[int, int]] = {}
        cursor = 0
        for key in live_keys:
            start, n = self.segments[key]
            cols.extend(range(start, start + n))
            new_segments[key] = (cursor, n)
            cursor += n
        new_cap = max(self.col_unit, _round_up(max(cursor, 1), self.col_unit))
        if cols:
            idx = jnp.asarray(np.asarray(cols, dtype=np.int32))
            new_bank = sharded_take_columns(self.mesh, self.bank2d, idx, new_cap)
        else:
            new_bank = sharded_zeros(self.mesh, self.num_rows, new_cap)
        self.bank2d = new_bank
        self.capacity = new_cap
        self.segments = new_segments
        self.used = cursor
        self.dead = 0


class DeviceProbeBackend:
    """Caches filter banks on device and serves batched probes.

    ``probe_groups`` is the query-path entry point: given every candidate
    (file, bank-group) of a query, it ensures residency, runs ONE probe
    program per superbank, and returns each file-group's term-match slice.
    """

    def __init__(
        self,
        cache_bytes: int = 2 << 30,
        mesh_devices: int | None = None,
    ):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self._jnp = jnp
        from .. import route

        self.platform = route.platform()
        if route.is_accelerator(self.platform):
            # Accelerator compiles cost seconds and amortize across
            # processes; CPU compiles are fast and persisting them floods
            # restarts with XLA:CPU AOT machine-feature warnings.
            route.enable_compile_cache()
        self.cache_bytes = cache_bytes

        # Multi-device: shard every superbank's block axis over a 1-D mesh.
        # mesh_devices=None is auto (all visible devices when >1); 1 forces
        # single-device. This is the engine-integrated form of the
        # reference's data-parallel block worker pool
        # (bloom_tree_engine.go:1019-1054) mapped onto devices.
        n_visible = len(jax.devices())
        want = n_visible if mesh_devices is None else mesh_devices
        if want > n_visible:
            raise RuntimeError(
                f"mesh_devices={want} but only {n_visible} device(s) visible"
            )
        if want > 1:
            from ..parallel.mesh import default_mesh

            self.mesh = default_mesh(n_devices=want)
        else:
            self.mesh = None
        self._lock = threading.RLock()
        self._superbanks: dict[tuple, Superbank] = {}
        self._released = False  # set by release(); blocks late re-uploads
        # Cross-query launch batching (see _probe_superbank_batched).
        self._batch_lock = threading.Lock()
        self._batch_pending: dict[int, _BankBatchEntry] = {}
        self.launches = 0  # observability: actual device launches
        # Launches per fused program: "reduce" (flat-AND), "clauses" (CNF),
        # "full" (whole [T, C] bitmap).
        self.program_launches = {"reduce": 0, "clauses": 0, "full": 0}
        self.batched_requests = 0  # total probe requests served
        self.aot_failures = 0  # precompile shapes that failed to compile
        # LRU order of inserted (superbank key, segment key) for eviction.
        self._lru: dict[tuple, None] = {}
        # file pointer -> [(superbank key, segment key)] for invalidation.
        self._by_file: dict[bytes, list[tuple[tuple[int, int], bytes]]] = {}

    # -- residency ------------------------------------------------------

    @staticmethod
    def segment_key(file_pointer: bytes, group_idx: int) -> bytes:
        return hashlib.blake2b(
            file_pointer + b"#" + str(group_idx).encode(), digest_size=16
        ).digest()

    def total_bytes(self) -> int:
        with self._lock:
            return sum(sb.nbytes for sb in self._superbanks.values())

    def stats(self) -> dict:
        """Public observability snapshot (the contract engine.stats() uses)."""
        with self._lock:
            superbanks = {
                f"m={mk[0]},k={mk[1]},{mk[2]}": {
                    "blocks": sb.used - sb.dead,
                    "dead": sb.dead,
                    "capacity": sb.capacity,
                    "bytes": sb.nbytes,
                }
                for mk, sb in self._superbanks.items()
            }
            total = sum(sb.nbytes for sb in self._superbanks.values())
        return {
            "platform": self.platform,
            "mesh_devices": self.mesh.shape["blocks"] if self.mesh is not None else 1,
            "superbank_bytes": total,
            "superbanks": superbanks,
            "probe_launches": self.launches,
            "probe_program_launches": dict(self.program_launches),
            "probe_aot_failures": self.aot_failures,
            "probe_requests": self.batched_requests,
        }

    def is_resident(self, mk: tuple, seg_key: bytes) -> bool:
        with self._lock:
            sb = self._superbanks.get(mk)
            return sb is not None and seg_key in sb.segments

    def release(self) -> None:
        """Free all superbank device memory NOW (engine shutdown).

        jax Arrays release HBM only when their last Python reference dies;
        explicit Array.delete() returns it immediately even if engine/
        thread cycles keep the backend object alive (a later engine in the
        same process would otherwise see RESOURCE_EXHAUSTED at warmup).
        Probes after release fail on the deleted arrays — start-after-stop
        is already forbidden at the engine layer.
        """
        with self._lock:
            self._released = True
            banks = list(self._superbanks.values())
            self._superbanks.clear()
            self._lru.clear()
            self._by_file.clear()
        for sb in banks:
            arr, sb.bank2d = sb.bank2d, None
            sb.segments = {}
            sb.capacity = sb.used = sb.dead = 0
            if arr is not None:
                try:
                    arr.delete()
                except Exception:  # pragma: no cover - already deleted
                    pass

    def invalidate(self, file_pointer: bytes) -> None:
        """Drop any cached banks of a tombstoned/replaced file."""
        with self._lock:
            for mk, seg_key in self._by_file.pop(file_pointer, []):
                sb = self._superbanks.get(mk)
                if sb is not None:
                    sb.remove(seg_key)
                    sb.maybe_compact()
                self._lru.pop((mk, seg_key), None)

    def _ensure_resident(
        self,
        file_pointer: bytes,
        mk: tuple,
        seg_key: bytes,
        loader: Callable[[], np.ndarray],
        yield_to=None,
    ) -> Superbank:
        """``yield_to``: background callers (warmup loop, scheduled bank
        warms) pass the engine's queries-in-flight gate so the staging
        uploads pause for foreground queries; query-path callers MUST pass
        None (yielding to themselves would stall the query)."""
        with self._lock:
            if self._released:
                raise BackendReleasedError("probe backend released")
            sb = self._superbanks.get(mk)
            if sb is None:
                sb = Superbank(mk[0], mk[1], mk[2], self._jnp, self._jax, mesh=self.mesh)
                self._superbanks[mk] = sb
            resident = seg_key in sb.segments
        if not resident:
            # Load AND device-stage OUTSIDE the lock (disk read + host work
            # + piecewise h2d); concurrent loaders of the same segment waste
            # a read but stay correct — the re-check under the lock inserts
            # only once. Staging outside the lock also keeps query probes
            # (which need the lock) from blocking behind the upload.
            host_bank = loader()
            staged = sb.stage(host_bank, yield_to=yield_to)
            with self._lock:
                if self._released:
                    # A warm that raced engine shutdown past release():
                    # inserting would allocate device memory owned by a dead
                    # engine's (cycle-kept) backend — the leak release()
                    # exists to prevent.
                    raise BackendReleasedError("probe backend released")
                sb = self._superbanks.get(mk)
                if sb is None:
                    sb = Superbank(
                        mk[0], mk[1], mk[2], self._jnp, self._jax, mesh=self.mesh
                    )
                    self._superbanks[mk] = sb
                if seg_key not in sb.segments:
                    sb.insert(seg_key, host_bank, staged=staged)
                    self._by_file.setdefault(file_pointer, []).append((mk, seg_key))
        with self._lock:
            self._lru.pop((mk, seg_key), None)
            self._lru[(mk, seg_key)] = None
            self._evict_if_needed()
            return sb

    def _reclaimable_bytes(self) -> int:
        """Bytes held by dead (tombstoned/evicted) columns, freeable by
        compaction without losing any warm segment."""
        return sum(
            sb.dead * sb.num_rows * 4 for sb in self._superbanks.values()
        )

    def _evict_if_needed(self) -> None:
        # Budget against the POST-compaction footprint: total_bytes() counts
        # capacity incl. dead columns, and an at-capacity insert would
        # otherwise evict ~half a superbank's LIVE warm segments before a
        # single real byte frees (rowcache.pin's sibling budget subtracts
        # dead chunks the same way).
        while (
            self.total_bytes() - self._reclaimable_bytes() > self.cache_bytes
            and len(self._lru) > 1
        ):
            (mk, seg_key), _ = next(iter(self._lru.items()))
            self._lru.pop((mk, seg_key))
            sb = self._superbanks.get(mk)
            if sb is not None:
                sb.remove(seg_key)
                sb.maybe_compact()
            for pointer, segs in list(self._by_file.items()):
                remaining = [s for s in segs if s != (mk, seg_key)]
                if len(remaining) != len(segs):
                    if remaining:
                        self._by_file[pointer] = remaining
                    else:
                        self._by_file.pop(pointer)
                    break
        # Live fits but dead columns still hold REAL device memory past the
        # budget (maybe_compact's dead*2 >= used threshold hasn't tripped):
        # force the reclaim now rather than serving over-budget until it
        # does. Largest reclaim first, re-testing the budget between banks —
        # each forced compaction is a full-bank device gather under this
        # lock, and compacting EVERY dead-holding bank when one would do
        # stalls concurrent queries behind N copies instead of one.
        if self.total_bytes() > self.cache_bytes:
            for sb in sorted(
                self._superbanks.values(),
                key=lambda s: s.dead * s.num_rows,
                reverse=True,
            ):
                if self.total_bytes() <= self.cache_bytes:
                    break
                if sb.dead > 0:
                    sb.maybe_compact(force=True)

    # -- probing --------------------------------------------------------

    def precompile_probe_programs(self, yield_to=None) -> int:
        """AOT-compile (.lower().compile()) the probe program ladder for
        every resident superbank shape, WITHOUT the per-bank launch lock.

        ``yield_to``: optional callable invoked between programs — tracing/
        lowering runs on the HOST and on few-core machines it starves a
        concurrent query's own host work (plan, native block scan, its own
        trace if its shape isn't cached yet); the engine passes its
        queries-in-flight pause gate.

        The warmup probe pass executes each ladder rung through the launch
        combiner, holding the bank's launch lock for the full multi-second
        compile — a query probing mid-warmup starved behind it on 1-core
        hosts. Running this AOT pass first populates jax's in-memory +
        persistent compilation caches, so the locked executions (and any
        query launch) deserialize instead of compiling.
        Covers solo flat-AND (reduce), CNF-clause (Cp/Mp 16 floors), and
        the full-bitmap program at every pow2 term pad <= 16 — the same
        shape space _probe_superbank_batched can launch. A shape that fails
        is counted in ``aot_failures`` and logged; returns programs
        compiled.
        """
        jnp = self._jnp
        with self._lock:
            snapshots = [
                (mk, sb.bank2d, sb.k) for mk, sb in self._superbanks.items()
            ]
        from .device_probe import (
            probe_and_pack,
            probe_clauses_pack,
            probe_reduce_and_pack,
        )

        compiled = 0
        for mk, bank2d, k in snapshots:
            for Tp in (1, 2, 4, 8, 16):
                rows = jnp.zeros((Tp * k,), jnp.int32)
                shifts = jnp.zeros((Tp * k,), jnp.int32)
                mask = jnp.ones((Tp,), bool)
                clause = jnp.zeros((16, Tp), jnp.float32)
                member = jnp.zeros((16, 16), jnp.float32)
                if self.mesh is not None:
                    from ..parallel.mesh import (
                        sharded_probe_clauses,
                        sharded_probe_packed,
                        sharded_query_step,
                    )

                    specs = [
                        lambda: sharded_query_step.lower(
                            self.mesh, bank2d, rows, shifts, mask, Tp, k
                        ),
                        lambda: sharded_probe_clauses.lower(
                            self.mesh, bank2d, rows, shifts, clause, member, Tp, k
                        ),
                        lambda: sharded_probe_packed.lower(
                            self.mesh, bank2d, rows, shifts, Tp, k
                        ),
                    ]
                else:
                    specs = [
                        lambda: probe_reduce_and_pack.lower(
                            bank2d, rows, shifts, Tp, k, mask
                        ),
                        lambda: probe_clauses_pack.lower(
                            bank2d, rows, shifts, Tp, k, clause, member
                        ),
                        lambda: probe_and_pack.lower(bank2d, rows, shifts, Tp, k),
                    ]
                for spec in specs:
                    if yield_to is not None:
                        yield_to()
                    try:
                        spec().compile()
                        compiled += 1
                    except Exception:
                        self.aot_failures += 1
                        logger.warning(
                            "probe AOT failed (mk=%s Tp=%d)", mk, Tp,
                            exc_info=True,
                        )
        return compiled

    def probe_groups(
        self,
        requests: list[tuple[bytes, int, tuple[int, int], Callable[[], np.ndarray]]],
        terms,
        reduce_and: bool = False,
        clause_mask: Optional[np.ndarray] = None,
    ) -> dict[tuple[bytes, int], np.ndarray]:
        """Batched probe across files.

        ``requests``: (file_pointer, group_idx, (m_bits, k, layout), loader)
        where ``loader()`` reads the host bank uint32[3, W, B] if not yet
        resident. Returns {(file_pointer, group_idx): bool[T, B] match slice}.

        With ``reduce_and`` (flat-AND queries — the dominant shape), the
        AND over terms fuses into the probe program on-device and the
        returned slices are bool[1, B] survivor vectors: a T× smaller
        device→host transfer and no host expression evaluation.

        ``clause_mask`` (bool[C, T] from probe.compile_cnf_clauses) extends
        the same fusion to arbitrary monotone AND/OR trees: the CNF
        evaluates on-device and a bool[1, B] survivor vector returns. Pass
        it for flat-AND too (as the identity) so combined cross-query
        launches can fuse every member; shapes that exceed the CNF budget
        pass None and evaluate host-side over the full bitmap.

        Concurrency: residency may race with invalidation/compaction, so the
        bank array and all segment placements snapshot atomically under the
        lock; device arrays are immutable, so probing the captured array with
        the captured placements stays consistent even if a concurrent
        tombstone compacts the live superbank meanwhile.
        """
        for _attempt in range(4):
            for file_pointer, group_idx, mk, loader in requests:
                seg_key = self.segment_key(file_pointer, group_idx)
                self._ensure_resident(file_pointer, mk, seg_key, loader)

            placements: dict[tuple[bytes, int], tuple[tuple, int, int]] = {}
            snapshots: dict[tuple, tuple] = {}
            with self._lock:
                ok = True
                for file_pointer, group_idx, mk, loader in requests:
                    seg_key = self.segment_key(file_pointer, group_idx)
                    sb = self._superbanks.get(mk)
                    if sb is None or seg_key not in sb.segments:
                        ok = False  # evicted between ensure and snapshot
                        break
                    start, n = sb.segments[seg_key]
                    placements[(file_pointer, group_idx)] = (mk, start, n)
                    snapshots[mk] = (sb.bank2d, sb.num_words, sb.capacity, sb.k, sb.layout, sb.m_bits)
            if not ok:
                continue

            matches: dict[tuple, np.ndarray] = {}
            for mk, (bank2d, num_words, capacity, k, layout, m_bits) in snapshots.items():
                word_idx, bit_idx = terms.positions_for(m_bits, k, layout)
                flat_rows = (
                    terms.ks_idx[:, None].astype(np.int32) * num_words + word_idx
                ).reshape(-1)
                matches[mk] = self._probe_superbank_batched(
                    bank2d,
                    capacity,
                    k,
                    flat_rows,
                    bit_idx.reshape(-1).astype(np.int32),
                    len(terms),
                    reduce_and,
                    clause_mask,
                )

            return {
                key: matches[mk][:, start : start + n]
                for key, (mk, start, n) in placements.items()
            }
        raise RuntimeError("bank segments kept churning during probe; cache too small?")

    # -- cross-query launch batching -------------------------------------

    def _probe_superbank_batched(
        self,
        bank2d,
        capacity: int,
        k: int,
        flat_rows: np.ndarray,
        shifts: np.ndarray,
        T: int,
        reduce_and: bool,
        clause_mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Probe one superbank snapshot, coalescing concurrent queries.

        Windowless batching: while one launch is in flight (its leader holds
        the per-bank launch lock), probes from other queries queue; whoever
        acquires the lock next launches EVERYTHING queued as one combined
        term batch and distributes the slices. Single queries see zero added
        latency; concurrent queries share launches — the per-launch cost
        (dispatch plus the result transfer) amortizes across queries.

        Shape-space discipline: NO launch may exceed the program shapes
        warmup precompiles (Tp<=16, Cp=Mp=16) — an oversized solo request
        would otherwise pay a fresh jit on first use. Requests with T > the term cap split into <=16-term
        chunks recombined host-side (AND for flat-AND; full-bitmap concat +
        host CNF otherwise); clause masks wider than the clause cap skip
        device fusion and evaluate host-side over the full bitmap. Both
        recombinations preserve this method's fusion contract ([1, B]
        survivors for reduce/clause requests).
        """
        if T > _PROBE_BATCH_MAX_TERMS:
            per = len(flat_rows) // T  # entries per term (= k hashes)
            parts = []
            for t0 in range(0, T, _PROBE_BATCH_MAX_TERMS):
                tn = min(_PROBE_BATCH_MAX_TERMS, T - t0)
                parts.append(
                    self._probe_superbank_batched(
                        bank2d, capacity, k,
                        flat_rows[t0 * per : (t0 + tn) * per],
                        shifts[t0 * per : (t0 + tn) * per],
                        tn, reduce_and, None,
                    )
                )
            if reduce_and:
                out = parts[0]
                for p in parts[1:]:
                    out = np.logical_and(out, p)
                return out
            full = np.concatenate(parts, axis=0)
            if clause_mask is not None:
                from .probe import evaluate_cnf_mask

                return evaluate_cnf_mask(clause_mask, full)[None, :]
            return full
        if (
            clause_mask is not None
            and not reduce_and
            and clause_mask.shape[0] > _PROBE_BATCH_MAX_CLAUSES
        ):
            full = self._probe_superbank_batched(
                bank2d, capacity, k, flat_rows, shifts, T, False, None
            )
            from .probe import evaluate_cnf_mask

            return evaluate_cnf_mask(clause_mask, full)[None, :]

        req = _PendingProbe(flat_rows, shifts, T, reduce_and, clause_mask)
        key = id(bank2d)
        with self._batch_lock:
            entry = self._batch_pending.get(key)
            # id() keys can recycle after GC: holding the bank ref in the
            # entry pins it, so an identity mismatch means a genuinely new
            # array took the address after the old entry drained.
            if entry is None or entry.bank is not bank2d:
                entry = _BankBatchEntry(bank2d)
                self._batch_pending[key] = entry
            entry.requests.append(req)
        # Loop until THIS request resolves: a leader drains at most a capped
        # FIFO prefix per launch (so combined launches never exceed the
        # program shapes warmup compiled — Tp/Cp/Mp 16); an undrained waiter
        # simply leads the next launch. Progress: every launch drains >= 1
        # request in FIFO order, and done-flags only flip under launch_lock.
        try:
            while not req.done.is_set():
                with entry.launch_lock:
                    if req.done.is_set():
                        break
                    # The entry stays in the map while this launch runs so
                    # new arrivals queue behind THIS lock (deleting it here
                    # would hand them a fresh, uncontended entry — no
                    # batching).
                    with self._batch_lock:
                        batch = []
                        total_t = total_c = 0
                        while entry.requests:
                            nxt = entry.requests[0]
                            nxt_c = (
                                nxt.clause_mask.shape[0]
                                if nxt.clause_mask is not None
                                else 0
                            )
                            if batch and (
                                len(batch) >= _PROBE_BATCH_MAX_MEMBERS
                                or total_t + nxt.T > _PROBE_BATCH_MAX_TERMS
                                or total_c + nxt_c > _PROBE_BATCH_MAX_CLAUSES
                            ):
                                break
                            batch.append(entry.requests.pop(0))
                            total_t += nxt.T
                            total_c += nxt_c
                    try:
                        self._launch_combined(bank2d, capacity, k, batch)
                    except BaseException as exc:
                        # Fail EVERYTHING pending on this entry, not just
                        # the drained batch: leaving undrained requests
                        # queued would abandon their waiting threads (and
                        # leak the entry's device-array ref if no further
                        # probe ever hits this bank). Each owner re-raises
                        # via its own req.error.
                        with self._batch_lock:
                            leftovers = entry.requests
                            entry.requests = []
                        for r in batch + leftovers:
                            r.error = exc
                            r.done.set()
                        break
        finally:
            # Drop the entry (and its bank ref) once nothing is pending; a
            # request appended concurrently keeps it alive and its own
            # thread will lead the next launch.
            with self._batch_lock:
                if self._batch_pending.get(key) is entry and not entry.requests:
                    del self._batch_pending[key]
        if req.error is not None:
            raise req.error
        return req.result

    def _launch_combined(
        self, bank2d, capacity: int, k: int, batch: list["_PendingProbe"]
    ) -> None:
        from .device_probe import (
            probe_and_pack,
            probe_clauses_pack,
            probe_reduce_and_pack,
        )

        jnp = self._jnp
        self.launches += 1
        self.batched_requests += len(batch)
        total_t = sum(r.T for r in batch)
        Tp = _pad_terms(total_t)
        flat_rows = np.concatenate([r.flat_rows for r in batch])
        shifts = np.concatenate([r.shifts for r in batch])
        if Tp != total_t:
            pad = (Tp - total_t) * k
            flat_rows = np.pad(flat_rows, (0, pad))
            shifts = np.pad(shifts, (0, pad))
        rows_dev = jnp.asarray(flat_rows)
        shifts_dev = jnp.asarray(shifts)

        # Fusion ladder:
        # 1. Solo flat-AND: the cheapest fully fused reduction (no matmuls).
        # 2. Every member carries a CNF clause mask: fuse ALL of them via
        #    the clause program — each member transfers only a [1, C/32]
        #    survivor bitmap, even for OR-shaped trees and even combined.
        # 3. Otherwise: full [T, C/32] bitmap back, host evaluation.
        solo_fused = len(batch) == 1 and batch[0].reduce_and
        all_clauses = not solo_fused and all(
            r.clause_mask is not None for r in batch
        )
        self.program_launches[
            "reduce" if solo_fused else "clauses" if all_clauses else "full"
        ] += 1
        clause_dev = member_dev = None
        if all_clauses:
            # Floors of 16: Cp/Mp only size tiny [M,C]x[C,T] matmuls, and
            # every distinct pad is a separate jit compile — a 16-floor
            # makes warmup's single-member clause probes produce the SAME
            # program shapes a <=16-way coalesced burst hits.
            total_c = sum(r.clause_mask.shape[0] for r in batch)
            Cp = max(_pad_terms(total_c), 16)
            Mp = max(_pad_terms(len(batch)), 16)
            clause = np.zeros((Cp, Tp), dtype=np.float32)
            member = np.zeros((Mp, Cp), dtype=np.float32)
            c0 = t0 = 0
            for mi, r in enumerate(batch):
                cm = r.clause_mask
                clause[c0 : c0 + cm.shape[0], t0 : t0 + r.T] = cm
                member[mi, c0 : c0 + cm.shape[0]] = 1.0
                c0 += cm.shape[0]
                t0 += r.T
            clause_dev = jnp.asarray(clause)
            member_dev = jnp.asarray(member)

        if self.mesh is not None:
            if solo_fused:
                from ..parallel.mesh import sharded_query_step

                packed, _total = sharded_query_step(
                    self.mesh, bank2d, rows_dev, shifts_dev,
                    jnp.asarray(np.arange(Tp) < total_t), Tp, k,
                )
                # Reshape on the host: an eager op on the replicated result
                # would be one more multi-device launch outside the lock.
                packed = np.asarray(packed)[None, :]
            elif all_clauses:
                from ..parallel.mesh import sharded_probe_clauses

                packed = sharded_probe_clauses(
                    self.mesh, bank2d, rows_dev, shifts_dev,
                    clause_dev, member_dev, Tp, k,
                )
            else:
                from ..parallel.mesh import sharded_probe_packed

                packed = sharded_probe_packed(
                    self.mesh, bank2d, rows_dev, shifts_dev, Tp, k
                )
        else:
            if solo_fused:
                packed = probe_reduce_and_pack(
                    bank2d, rows_dev, shifts_dev, Tp, k,
                    jnp.asarray(np.arange(Tp) < total_t),
                )
            elif all_clauses:
                packed = probe_clauses_pack(
                    bank2d, rows_dev, shifts_dev, Tp, k, clause_dev, member_dev
                )
            else:
                packed = probe_and_pack(bank2d, rows_dev, shifts_dev, Tp, k)
        # ascontiguousarray: np.asarray of a device array need not return a
        # C-contiguous buffer (a sharded result is assembled from per-device
        # pieces), and .view() below requires contiguity.
        packed_host = np.ascontiguousarray(np.asarray(packed))
        bits = np.unpackbits(packed_host.view(np.uint8), axis=1, bitorder="little")
        bits = bits[:, :capacity].astype(bool)

        if solo_fused:
            batch[0].result = bits[:1]
            batch[0].done.set()
            return
        if all_clauses:
            for mi, r in enumerate(batch):
                r.result = bits[mi : mi + 1]
                r.done.set()
            return
        cursor = 0
        for r in batch:
            sub = bits[cursor : cursor + r.T]
            cursor += r.T
            if r.reduce_and:
                sub = sub.all(axis=0, keepdims=True)
            elif r.clause_mask is not None:
                # Mixed batch took the full-bitmap path; honor this
                # member's fusion contract host-side so a clause request
                # ALWAYS yields [1, B] survivors.
                from .probe import evaluate_cnf_mask

                sub = evaluate_cnf_mask(r.clause_mask, sub)[None, :]
            r.result = sub
            r.done.set()


class _PendingProbe:
    __slots__ = (
        "flat_rows", "shifts", "T", "reduce_and", "clause_mask",
        "done", "result", "error",
    )

    def __init__(self, flat_rows, shifts, T, reduce_and, clause_mask=None):
        self.flat_rows = flat_rows
        self.shifts = shifts
        self.T = T
        self.reduce_and = reduce_and
        self.clause_mask = clause_mask  # bool[C, T] CNF; None = host eval
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _BankBatchEntry:
    __slots__ = ("bank", "requests", "launch_lock")

    def __init__(self, bank):
        self.bank = bank  # strong ref pins the id() while pending
        self.requests: list[_PendingProbe] = []
        self.launch_lock = threading.Lock()
