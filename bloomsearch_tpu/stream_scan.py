"""Stream scan: needle hits over the device row cache's chunk matrix.

The row cache (rowcache.py) keeps lowered row bytes as overlapped stream
chunks, packed little-endian four bytes per int32 word: ``int32[G, P4]``
with P4 = 128 words (512 bytes) per chunk. A needle of length L matches
chunk g at start byte s = 4p + a (a = s mod 4) iff the ceil((a+L)/4) words
from word p equal the needle's pattern words at alignment a under a byte
mask. Only starts in a chunk's payload count (s < 4 * valid_words; the
overlap tail belongs to the next chunk), so with L <= MAX_SCAN_WINDOW every
spanned word stays inside its own chunk.

Two implementations share one contract, ``-> packed uint32[n_real, G/32]``
per-chunk hit bitmap:

- :func:`scan_xla` — plain ``jnp``: the word loop is an unrolled chain of
  elementwise ops feeding one any-reduction, which XLA fuses into a single
  reduction over each chunk.
- :func:`scan_triton` — a Pallas kernel through Triton for the GPU: each
  program loads its ``[BG, P4]`` tile's W shifted word windows once and
  evaluates every needle x alignment against them in registers.

``route.scan_impl`` picks one per platform; :func:`scan_stream` dispatches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .bloom.device_probe import pack_bitmap

MAX_SCAN_WINDOW = 32  # must equal rowcache.MAX_NEEDLE
MAX_SCAN_NEEDLES = 8  # needles per launch (callers chunk above this)

# Word-loop buckets: a needle of length L at alignment a spans
# ceil((a+L)/4) <= ceil((L+3)/4) words. A launch runs its longest needle's
# bucket, so short-needle queries (the common case) do a fraction of the
# 9-word worst case's integer work; each bucket is its own compiled program
# per matrix shape and warmup compiles them all.
SCAN_WORD_BUCKETS = (2, 4, 6, 9)

# Triton tile: chunks per program and warps per program. 16 x 4 was the
# fastest of {16, 32, 64} chunks x {4, 8} warps on an H100 at every word
# bucket; 32 chunks with 4 warps runs out of registers for the 9-word
# bucket's windows (see PERF.md).
_TRITON_BLOCK_CHUNKS = 16
_TRITON_NUM_WARPS = 4


def scan_word_bucket(max_len: int) -> int:
    need = (max_len + 3 + 3) // 4
    for b in SCAN_WORD_BUCKETS:
        if need <= b:
            return b
    return SCAN_WORD_BUCKETS[-1]


def pattern_words(needles: jax.Array, lens: jax.Array, max_words: int):
    """int32[N, MAX_SCAN_WINDOW] bytes + int32[N] lengths ->
    (pattern, mask) uint32[N, 4, max_words], little-endian like the packed
    chunks. Byte b of word w at alignment a is needle byte 4w + b - a; bytes
    outside the needle have mask 0 (a zero-length needle matches anywhere)."""
    assert needles.shape[1] == MAX_SCAN_WINDOW, needles.shape
    j = (
        4 * jnp.arange(max_words)[None, :, None]
        + jnp.arange(4)[None, None, :]
        - jnp.arange(4)[:, None, None]
    )  # [4, W, 4]
    in_needle = (j >= 0) & (j < lens[:, None, None, None])  # [N, 4, W, 4]
    jc = jnp.clip(j, 0, MAX_SCAN_WINDOW - 1)
    nb = jnp.where(in_needle, needles[:, jc], 0).astype(jnp.uint32)
    mb = jnp.where(in_needle, jnp.uint32(0xFF), jnp.uint32(0))
    shifts = jnp.uint32(8) * jnp.arange(4, dtype=jnp.uint32)
    pat = jnp.sum(nb << shifts, axis=-1, dtype=jnp.uint32)
    msk = jnp.sum(mb << shifts, axis=-1, dtype=jnp.uint32)
    return pat, msk


def _check_shapes(rows32, needles, n_real, max_words, valid_words):
    G, P4 = rows32.shape
    assert needles.shape[1] == MAX_SCAN_WINDOW, needles.shape
    assert 0 < n_real <= needles.shape[0]
    assert G % 32 == 0, G  # whole bitmap words (and whole Triton tiles)
    # Every word a valid start spans lies inside its chunk.
    assert 0 < valid_words and valid_words + max_words - 1 <= P4


@functools.partial(jax.jit, static_argnames=("n_real", "max_words", "valid_words"))
def scan_xla(
    rows32: jax.Array,  # int32[G, P4] packed chunk bytes
    needles: jax.Array,  # int32[N, MAX_SCAN_WINDOW] byte values
    lens: jax.Array,  # int32[N]
    *,
    n_real: int,
    max_words: int,
    valid_words: int,
) -> jax.Array:
    """Plain-jnp SWAR scan -> packed uint32[n_real, G/32]."""
    _check_shapes(rows32, needles, n_real, max_words, valid_words)
    pat, msk = pattern_words(needles[:n_real], lens[:n_real], max_words)
    words = jax.lax.bitcast_convert_type(rows32, jnp.uint32)
    mismatch = None
    for w in range(max_words):
        win = words[:, None, None, w : w + valid_words]  # [G, 1, 1, V]
        term = (win ^ pat[None, :, :, w, None]) & msk[None, :, :, w, None]
        mismatch = term if mismatch is None else mismatch | term
    hit = jnp.any(mismatch == 0, axis=(2, 3))  # bool[G, n_real]
    return pack_bitmap(hit.T)


def _make_triton_kernel(n_real: int, n_out: int, W: int, BG: int, P4: int, V: int):
    def kernel(pat_ref, msk_ref, rows_ref, out_ref):
        cols = jax.lax.broadcasted_iota(jnp.int32, (BG, P4), 1)
        # Window w holds word p + w at lane p. The start is a traced scalar
        # so the slice may run past the block edge; the mask keeps those
        # lanes (never a valid start) from reading outside the matrix.
        wins = [
            plgpu.load(
                rows_ref.at[:, pl.ds(jnp.int32(w) if w else 0, P4)],
                mask=cols + w < P4,
                other=0,
            )
            for w in range(W)
        ]
        valid = cols < V
        for n in range(n_out):
            if n >= n_real:  # pow2 padding row of the output block
                out_ref[n, :] = jnp.zeros((BG,), jnp.int32)
                continue
            hit = jnp.zeros((BG,), jnp.int32)
            for a in range(4):
                base = (n * 4 + a) * W
                mismatch = jnp.zeros((BG, P4), jnp.int32)
                for w in range(W):
                    mismatch = mismatch | ((wins[w] ^ pat_ref[base + w]) & msk_ref[base + w])
                ok = jnp.where((mismatch == 0) & valid, 1, 0)
                hit = jnp.maximum(hit, jnp.max(ok, axis=1))
            out_ref[n, :] = hit

    return kernel


@functools.partial(
    jax.jit, static_argnames=("n_real", "max_words", "valid_words", "interpret")
)
def scan_triton(
    rows32: jax.Array,
    needles: jax.Array,
    lens: jax.Array,
    *,
    n_real: int,
    max_words: int,
    valid_words: int,
    interpret: bool = False,
) -> jax.Array:
    """Pallas/Triton SWAR scan -> packed uint32[n_real, G/32].

    ``interpret`` runs the kernel in Pallas's interpreter (CPU tests only;
    the GPU path always compiles it)."""
    _check_shapes(rows32, needles, n_real, max_words, valid_words)
    G, P4 = rows32.shape
    BG = _TRITON_BLOCK_CHUNKS
    W = max_words
    pat, msk = pattern_words(needles[:n_real], lens[:n_real], W)
    pat = jax.lax.bitcast_convert_type(pat, jnp.int32).reshape(-1)
    msk = jax.lax.bitcast_convert_type(msk, jnp.int32).reshape(-1)
    n_pat = n_real * 4 * W
    n_out = pl.next_power_of_2(n_real)  # Triton block dims are powers of two
    hit = pl.pallas_call(
        _make_triton_kernel(n_real, n_out, W, BG, P4, valid_words),
        grid=(G // BG,),
        in_specs=[
            pl.BlockSpec((n_pat,), lambda i: (0,)),
            pl.BlockSpec((n_pat,), lambda i: (0,)),
            pl.BlockSpec((BG, P4), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((n_out, BG), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((n_out, G), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_TRITON_NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="stream_scan",
    )(pat, msk, rows32)
    return pack_bitmap(hit[:n_real] != 0)


def scan_stream(rows32, needles, lens, *, impl: str, n_real: int, max_words: int,
                valid_words: int) -> jax.Array:
    """Dispatch to the implementation ``route.scan_impl`` chose."""
    if impl == "triton":
        return scan_triton(rows32, needles, lens, n_real=n_real,
                           max_words=max_words, valid_words=valid_words)
    if impl == "xla":
        return scan_xla(rows32, needles, lens, n_real=n_real,
                        max_words=max_words, valid_words=valid_words)
    raise ValueError(f"unknown scan implementation {impl!r}")
