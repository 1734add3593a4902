"""Multi-device probe and scan sharding over a jax.sharding.Mesh.

The reference's only scaling dimension is data-parallelism over blocks —
a bounded worker pool on one host (SURVEY.md §2, parallelism items 3-4) and
a README-only scatter/gather design (README.md:397-418). The device-native
equivalent maps that dimension onto the device mesh: the superbank's block
axis shards across devices (``P(None, "blocks")``), query-term probe
positions replicate (the broadcast), each device probes its local shard with
the same program (shard_map), and the packed per-block match bitmaps come
back through the all-gather XLA inserts when the sharded output is consumed
replicated (NCCL over NVLink on a GPU host). The mesh is 1-D: every card
reaches every other at the same rate.

Filter banks beyond one device's memory therefore scale linearly in devices,
and a query still costs ONE launch per param group regardless of mesh size.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..bloom.device_probe import cnf_survivors, pack_bitmap, probe_bank_xla

BLOCK_AXIS = "blocks"

# One lock for every multi-device program this process launches. Collectives
# rendezvous per execution: when several threads (warmup's bank, scan and pin
# passes beside queries) enqueue multi-device programs at once, the devices
# can receive them in different orders and each waits forever in a different
# program's collective (seen on four H100s as NCCL clique rendezvous with
# mismatched run ids). Holding the lock from dispatch until the result is
# ready keeps every device on the same program. Single-device calls
# (mesh=None) never take it.
MESH_LAUNCH_LOCK = threading.Lock()


def serialized_launch(jitted):
    """A jitted multi-device program whose every call holds MESH_LAUNCH_LOCK
    until its result is ready."""

    @functools.wraps(jitted)
    def launch(*args, **kwargs):
        with MESH_LAUNCH_LOCK:
            return jax.block_until_ready(jitted(*args, **kwargs))

    launch.lower = jitted.lower  # AOT precompiles dispatch nothing
    return launch


def _mesh_program(**jit_kwargs):
    """jax.jit for a program whose first argument is the (static) mesh; calls
    with a mesh go through serialized_launch."""

    def wrap(fn):
        jitted = jax.jit(fn, **jit_kwargs)
        locked = serialized_launch(jitted)

        @functools.wraps(fn)
        def launch(mesh, *args, **kwargs):
            return (jitted if mesh is None else locked)(mesh, *args, **kwargs)

        launch.lower = jitted.lower
        return launch

    return wrap


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the block axis (the data-parallel dimension)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (BLOCK_AXIS,))


def pad_columns_for_mesh(c: int, mesh: Mesh) -> int:
    """Columns must split evenly into 128-column shards."""
    n = mesh.shape[BLOCK_AXIS]
    unit = 128 * n
    return ((c + unit - 1) // unit) * unit


def bank_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(None, BLOCK_AXIS))


def _constrain(x: jax.Array, mesh: Optional[Mesh]) -> jax.Array:
    return x if mesh is None else jax.lax.with_sharding_constraint(x, bank_sharding(mesh))


# --- Sharding-preserving superbank maintenance ops -------------------------
#
# The engine's Superbank (bloom/bank.py) mutates its device array on flush
# (append columns), tombstone (compaction), and growth. Each op below keeps
# the block axis sharded across the mesh so a bank larger than one device
# stays usable; with mesh=None they lower to the plain single-device ops.
# None are on the query hot path — probes dominate; these run once per
# flush/merge.


@_mesh_program(static_argnames=("mesh", "rows", "cols"))
def sharded_zeros(mesh: Optional[Mesh], rows: int, cols: int) -> jax.Array:
    return _constrain(jnp.zeros((rows, cols), jnp.uint32), mesh)


@_mesh_program(static_argnames=("mesh", "new_cols"))
def sharded_pad_columns(mesh: Optional[Mesh], bank: jax.Array, new_cols: int) -> jax.Array:
    return _constrain(jnp.pad(bank, ((0, 0), (0, new_cols - bank.shape[1]))), mesh)


@_mesh_program(static_argnames=("mesh",))
def sharded_update_columns(
    mesh: Optional[Mesh], bank: jax.Array, chunk: jax.Array, start: jax.Array
) -> jax.Array:
    out = jax.lax.dynamic_update_slice(bank, chunk, (jnp.int32(0), start))
    return _constrain(out, mesh)


@_mesh_program(static_argnames=("mesh", "new_cols"))
def sharded_take_columns(
    mesh: Optional[Mesh], bank: jax.Array, idx: jax.Array, new_cols: int
) -> jax.Array:
    live = jnp.take(bank, idx, axis=1)
    out = jnp.zeros((bank.shape[0], new_cols), jnp.uint32)
    out = jax.lax.dynamic_update_slice(out, live, (0, 0))
    return _constrain(out, mesh)


def shard_bank(mesh: Mesh, bank2d: np.ndarray) -> jax.Array:
    """Place a host bank [rows, C] onto the mesh, block axis sharded.

    Pads C to a 128-column multiple per shard.
    """
    rows, c = bank2d.shape
    c_p = pad_columns_for_mesh(c, mesh)
    if c_p != c:
        padded = np.zeros((rows, c_p), dtype=np.uint32)
        padded[:, :c] = bank2d
        bank2d = padded
    sharding = NamedSharding(mesh, P(None, BLOCK_AXIS))
    return jax.device_put(jnp.asarray(bank2d), sharding)


@_mesh_program(static_argnames=("mesh", "T", "K", "gather"))
def sharded_probe_packed(
    mesh: Mesh,
    bank2d: jax.Array,  # [rows, C] sharded P(None, "blocks")
    row_idx: jax.Array,  # int32[T*K] replicated
    shift: jax.Array,  # int32[T*K] replicated
    T: int,
    K: int,
    gather: bool = True,
) -> jax.Array:
    """Probe every shard's blocks -> packed uint32[T, C/32] match bitmap.

    Each device runs the identical probe on its local block shard; the
    packed bitmaps concatenate along the block axis. With ``gather`` the
    result is replicated (XLA all-gathers the shards); otherwise it stays
    sharded for downstream sharded consumption.
    """

    def local(bank_local: jax.Array, fr: jax.Array, sh: jax.Array) -> jax.Array:
        return pack_bitmap(probe_bank_xla(bank_local, fr, sh, K))

    shmapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, BLOCK_AXIS), P(), P()),
        out_specs=P(None, BLOCK_AXIS),
    )
    packed = shmapped(bank2d, row_idx, shift)
    if gather:
        packed = jax.lax.with_sharding_constraint(
            packed, NamedSharding(mesh, P())
        )
    return packed


@_mesh_program(static_argnames=("mesh", "T", "K"))
def sharded_query_step(
    mesh: Mesh,
    bank2d: jax.Array,  # [rows, C] sharded P(None, "blocks")
    row_idx: jax.Array,
    shift: jax.Array,
    and_mask: jax.Array,  # bool[T]: terms under the top-level AND
    T: int,
    K: int,
):
    """The full sharded query step: probe + expression reduce + global stats.

    Evaluates a top-level AND over the masked terms entirely on-device
    (arbitrary AND/OR trees take sharded_probe_clauses; the flat-AND case —
    the overwhelmingly common query shape — stays fused here), packs the
    surviving-block bitmap, and psums the per-shard survivor count so the
    scheduler can size the decode worker pool without waiting for the
    bitmap transfer.

    Returns (packed_survivors uint32[C/32] replicated, total_survivors i32).
    """

    def local(bank_local, fr, sh, mask):
        match = probe_bank_xla(bank_local, fr, sh, K)
        # AND over active terms; inactive terms contribute True.
        survives = jnp.all(match | ~mask[:, None], axis=0)  # bool[C_local]
        packed = pack_bitmap(survives[None, :])[0]  # uint32[C_local/32]
        count = jnp.sum(survives.astype(jnp.int32))
        total = jax.lax.psum(count, BLOCK_AXIS)
        return packed, total

    shmapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, BLOCK_AXIS), P(), P(), P()),
        out_specs=(P(BLOCK_AXIS), P()),
    )
    packed, total = shmapped(bank2d, row_idx, shift, and_mask)
    packed = jax.lax.with_sharding_constraint(packed, NamedSharding(mesh, P()))
    return packed, total


@_mesh_program(static_argnames=("mesh", "T", "K"))
def sharded_probe_clauses(
    mesh: Mesh,
    bank2d: jax.Array,  # [rows, C] sharded P(None, "blocks")
    row_idx: jax.Array,
    shift: jax.Array,
    clause_mask: jax.Array,  # float32[Cl, T] replicated
    member_mask: jax.Array,  # float32[M, Cl] replicated
    T: int,
    K: int,
) -> jax.Array:
    """Sharded probe + fused CNF evaluation -> packed uint32[M, C/32].

    The multi-device form of device_probe.probe_clauses_pack: each device
    probes its block shard and reduces the CNF locally; only the
    per-member survivor bitmaps cross devices when the replicated result
    gathers.
    """

    def local(bank_local, fr, sh, cmask, mmask):
        match = probe_bank_xla(bank_local, fr, sh, K)
        return pack_bitmap(cnf_survivors(match, cmask, mmask))

    shmapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, BLOCK_AXIS), P(), P(), P(), P()),
        out_specs=P(None, BLOCK_AXIS),
    )
    packed = shmapped(bank2d, row_idx, shift, clause_mask, member_mask)
    return jax.lax.with_sharding_constraint(packed, NamedSharding(mesh, P()))


def unpack_bitmap(packed: np.ndarray, num_cols: int) -> np.ndarray:
    """uint32[..., C/32] -> bool[..., num_cols]."""
    bits = np.unpackbits(
        np.ascontiguousarray(packed).view(np.uint8), axis=-1, bitorder="little"
    )
    return bits[..., :num_cols].astype(bool)


# --- Row-axis variants (serving row cache) ----------------------------------
#
# The device row cache shards its stream matrix along CHUNKS over the same
# 1-D mesh (int32[chunks, 128], P("blocks", None)): pinned capacity and scan
# compute then scale linearly in devices, mirroring what the column helpers
# above do for filter superbanks.


def rows_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BLOCK_AXIS, None))


def _constrain_rows(x: jax.Array, mesh: Optional[Mesh]) -> jax.Array:
    return x if mesh is None else jax.lax.with_sharding_constraint(x, rows_sharding(mesh))


@_mesh_program(static_argnames=("mesh", "rows", "cols", "dtype"))
def sharded_zeros_rows(
    mesh: Optional[Mesh], rows: int, cols: int, dtype=jnp.uint8
) -> jax.Array:
    return _constrain_rows(jnp.zeros((rows, cols), dtype), mesh)


@_mesh_program(static_argnames=("mesh", "new_rows"))
def sharded_pad_rows(mesh: Optional[Mesh], mat: jax.Array, new_rows: int) -> jax.Array:
    return _constrain_rows(jnp.pad(mat, ((0, new_rows - mat.shape[0]), (0, 0))), mesh)


@_mesh_program(static_argnames=("mesh",))
def sharded_update_rows(
    mesh: Optional[Mesh], mat: jax.Array, chunk: jax.Array, start: jax.Array
) -> jax.Array:
    out = jax.lax.dynamic_update_slice(mat, chunk, (start, jnp.int32(0)))
    return _constrain_rows(out, mesh)


@_mesh_program(static_argnames=("mesh",), donate_argnums=(1,))
def sharded_update_rows_donated(
    mesh: Optional[Mesh], mat: jax.Array, chunk: jax.Array, start: jax.Array
) -> jax.Array:
    """In-place variant of sharded_update_rows: donates ``mat`` so XLA
    aliases the output buffer instead of copying the (multi-GB at serving
    scale) stream matrix per upload piece. ONLY safe for chain
    intermediates the caller privately owns — donating the published
    matrix snapshot would invalidate it under concurrent scans
    (rowcache.pin tracks privateness explicitly)."""
    out = jax.lax.dynamic_update_slice(mat, chunk, (start, jnp.int32(0)))
    return _constrain_rows(out, mesh)


@_mesh_program(static_argnames=("mesh", "new_rows"))
def sharded_take_rows(
    mesh: Optional[Mesh], mat: jax.Array, idx: jax.Array, new_rows: int
) -> jax.Array:
    live = jnp.take(mat, idx, axis=0)
    out = jnp.zeros((new_rows, mat.shape[1]), mat.dtype)
    out = jax.lax.dynamic_update_slice(out, live, (0, 0))
    return _constrain_rows(out, mesh)


def sharded_scan_all_rows(
    mesh: Mesh,
    rows32: jax.Array,  # int32[R, P4] stream chunks, sharded P("blocks", None)
    needles: jax.Array,  # int32[N, MAX_SCAN_WINDOW]
    lens: jax.Array,  # int32[N]
    *,
    impl: str,
    n_real: int,
    max_words: int,
    valid_words: int,
) -> jax.Array:
    """Scan every resident chunk on its own device -> packed
    uint32[n_real, R/32] per-chunk bitmap, replicated.

    Traced inside the row cache's jitted scan (rowcache._device_scan_fn),
    which launches through serialized_launch.

    Each device runs the stream scan (``impl``, as route.scan_impl chose)
    over its local chunk shard; chunks stay contiguous per shard, so the
    per-shard bitmaps concatenate along the word axis bit-for-bit with the
    unsharded scan's output. The row cache pads capacity to 512 x mesh size
    chunks, so every shard splits into whole bitmap words. Chunk overlap
    bytes are duplicated INTO each chunk at pack time, so shard boundaries
    need no halo exchange.
    """
    from ..stream_scan import scan_stream

    def local_scan(rows_l, needles_l, lens_l):
        return scan_stream(
            rows_l, needles_l, lens_l, impl=impl,
            n_real=n_real, max_words=max_words, valid_words=valid_words,
        )

    shmapped = shard_map(
        local_scan,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS, None), P(), P()),
        out_specs=P(None, BLOCK_AXIS),
        # A Pallas kernel's outputs carry no varying-across-mesh type; the
        # body is purely shard-local.
        check_vma=False,
    )
    packed = shmapped(rows32, needles, lens)
    return jax.lax.with_sharding_constraint(packed, NamedSharding(mesh, P()))
