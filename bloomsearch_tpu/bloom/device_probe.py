"""Device bloom bank probe programs (XLA-compiled).

The probe is the query hot path (SURVEY.md §3.3): for T query terms with k
probe positions each, test bits across C blocks. The superbank layout
``[rows, C]`` (row = keyspace*num_words + word) makes every (term, probe) a
*contiguous row read* of C words instead of the word-at-a-time gathers the
reference's per-filter ``TestString`` does (bloom_tree_engine.go:890-903).

On the GPU a probed row is C contiguous words, so the row gather is
coalesced and XLA fuses gather, shift, AND over the k probes, the optional
term reduction and the bit-pack into one fusion: the bytes a probe needs
are T·K·C·4 and the ``[T*K, C]`` gathered rows are never written out.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def pack_bitmap(match: jax.Array) -> jax.Array:
    """bool[T, C] -> uint32[T, C/32] little-endian bit packing.

    THE bitmap contract shared by every device producer (probe programs,
    stream scan, mesh collectives) and the host-side unpack — keep the one
    copy here."""
    T, C = match.shape
    groups = match.reshape(T, C // 32, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(jnp.where(groups, weights, jnp.uint32(0)), axis=2, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("K",))
def probe_bank_xla(bank2d: jax.Array, row_idx: jax.Array, shift: jax.Array, K: int) -> jax.Array:
    """uint32[R, C] bank, int32[T*K] rows and bit shifts -> bool[T, C]."""
    rows = bank2d[row_idx]  # [T*K, C]; fused into the consumer, never materialized
    bits = jax.lax.shift_right_logical(rows, shift[:, None].astype(jnp.uint32)) & jnp.uint32(1)
    T = row_idx.shape[0] // K
    return jnp.all(bits.reshape(T, K, -1) == 1, axis=1)


@functools.partial(jax.jit, static_argnames=("T", "K"))
def probe_and_pack(
    bank2d: jax.Array, row_idx: jax.Array, shift: jax.Array, T: int, K: int
) -> jax.Array:
    """Probe then pack the [T, C] match matrix into uint32 bitmap words.

    The packed [T, C/32] result is 32x smaller, keeping the per-query
    device→host transfer tiny (the match bitmap is the only thing the query
    planner needs back from the device).
    """
    del T  # implied by len(row_idx); kept in the signature every caller shares
    return pack_bitmap(probe_bank_xla(bank2d, row_idx, shift, K))


@functools.partial(jax.jit, static_argnames=("T", "K"))
def probe_reduce_and_pack(
    bank2d: jax.Array,
    row_idx: jax.Array,
    shift: jax.Array,
    T: int,
    K: int,
    and_mask: jax.Array,  # bool[T]: terms participating in the AND
) -> jax.Array:
    """Probe + fused flat-AND reduction -> packed uint32[1, C/32] survivors.

    The single-device form of mesh.sharded_query_step's body: for the
    dominant query shape (every term AND-ed), the [T, C] match matrix never
    leaves the device — the AND over active terms happens on-chip and only
    a [C/32] survivor bitmap transfers (T× less than probe_and_pack).
    Inactive (padding) terms contribute True.
    """
    del T
    match = probe_bank_xla(bank2d, row_idx, shift, K)
    survives = jnp.all(match | ~and_mask[:, None], axis=0)  # bool[C]
    return pack_bitmap(survives[None, :])


def cnf_survivors(match: jax.Array, clause_mask: jax.Array, member_mask: jax.Array) -> jax.Array:
    """bool[T, C] matches -> bool[M, C]: member m survives where none of its
    clauses is false. Two small float32 products of 0/1 values with sums of
    at most T; ``HIGHEST`` keeps them out of reduced-precision (TF32) paths
    so the counts stay exact."""
    hi = jax.lax.Precision.HIGHEST
    m = match.astype(jnp.float32)
    clause_false = jnp.matmul(clause_mask, m, precision=hi) < 0.5  # [Cl, C]
    viol = jnp.matmul(member_mask, clause_false.astype(jnp.float32), precision=hi) > 0.5
    return ~viol


@functools.partial(jax.jit, static_argnames=("T", "K"))
def probe_clauses_pack(
    bank2d: jax.Array,
    row_idx: jax.Array,
    shift: jax.Array,
    T: int,
    K: int,
    clause_mask: jax.Array,  # float32[Cl, T] — CNF clauses over terms
    member_mask: jax.Array,  # float32[M, Cl] — which clauses belong to which query
) -> jax.Array:
    """Probe + fused CNF evaluation -> packed uint32[M, C/32] survivors.

    Arbitrary (monotone) AND/OR trees evaluate on-device as two small
    matmuls over the [T, C] match matrix: clause_or = (clause_mask @ match)
    > 0, survivors[m] = no clause of member m is false. Per combined-launch
    member only a [C/32] bitmap transfers — the same fused-transfer win
    flat-AND gets from probe_reduce_and_pack, extended to every tree shape
    compile_cnf_clauses handles. Padding clauses (all-zero member columns)
    and padding members (all-zero clause rows) are inert by construction.
    """
    del T
    match = probe_bank_xla(bank2d, row_idx, shift, K)
    return pack_bitmap(cnf_survivors(match, clause_mask, member_mask))
