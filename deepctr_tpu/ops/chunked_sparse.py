"""Chunked sparse gather/densify for giant embedding tables.

An execution strategy for gather and scatter-add whose per-row cost grows
with the TARGET array size: keep each target small.  With ids SORTED, the occurrences that touch vocab chunk ``c`` form one contiguous
range ``[bounds[c], bounds[c+1])``, so a giant-table gather/scatter
decomposes into per-chunk small-array ops:

- **densify** (gradient scatter): each chunk's dense gradient block is
  built by scattering a W-row window of the sorted occurrence array into a
  ``[CH, D]`` zeros block (small target -> fast path), blocks concatenate
  into the full ``[Vp, D]`` gradient.
- **gather**: each chunk's rows come from a ``take`` against the chunk's
  ``[CH, D]`` slice, blended into the sorted output window by window.

Windows have STATIC size W (XLA requirement).  If a batch is so skewed
that one chunk receives more than W occurrences (counted exactly), a
``lax.cond`` falls back to one direct big-table op for the un-applied
remainder — semantics are ALWAYS exact; the fast path is only a schedule.

Reference parity: pure execution strategy for C10's segment-sum scatter
(SURVEY.md §2.1); the training math is bit-comparable to the direct path
(duplicates still sum in sorted order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# target-chunk rows: [CHUNK, D] f32 at D=11 is ~1.4 MB
DEFAULT_CHUNK = 32_768
# occurrence-window rows per chunk; overflow falls back exactly.  24.6k
# occurrences over 29 chunks average ~850/chunk -> 4096 is ~4.8x headroom
DEFAULT_WINDOW = 4096
# only decompose tables of at least this many rows
MIN_ROWS_TO_CHUNK = 262_144


def _bounds(sid: jax.Array, vocab_rows: int, chunk: int) -> jax.Array:
    nchunks = -(-vocab_rows // chunk)
    edges = jnp.arange(nchunks + 1, dtype=jnp.int32) * chunk
    return jnp.searchsorted(sid, edges).astype(jnp.int32)


def _window_offsets(bounds: jax.Array, m: int, window: int) -> jax.Array:
    """Clamped window start per chunk (window always fits inside [0, m))."""
    return jnp.minimum(bounds[:-1], max(m - window, 0))


def _applied_mask(sid, bounds, offs, chunk, window):
    """bool[M]: occurrence j is covered by its chunk's window."""
    cj = sid // chunk                          # chunk of each occurrence
    cj = jnp.clip(cj, 0, offs.shape[0] - 1)
    off_j = jnp.take(offs, cj)
    j = jnp.arange(sid.shape[0], dtype=jnp.int32)
    return j < off_j + window


def densify_sorted(
    sid: jax.Array,
    srows: jax.Array,
    vocab_rows: int,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
) -> jax.Array:
    """Dense ``g[vocab_rows, D] = segment_sum(srows at sid)``; sid SORTED.

    ids outside [0, vocab_rows) contribute nothing.  Exact for any input
    (window overflow handled by a direct-scatter fallback branch).
    """
    m, d = srows.shape
    if vocab_rows < MIN_ROWS_TO_CHUNK or m <= window:
        return jnp.zeros((vocab_rows, d), srows.dtype).at[sid].add(
            srows, mode="drop", indices_are_sorted=True
        )
    nchunks = -(-vocab_rows // chunk)
    bounds = _bounds(sid, vocab_rows, chunk)
    offs = _window_offsets(bounds, m, window)

    blocks = []
    for c in range(nchunks):
        off = offs[c]
        wid = jax.lax.dynamic_slice(sid, (off,), (window,))
        wrow = jax.lax.dynamic_slice(srows, (off, 0), (window, d))
        local = wid - c * chunk
        valid = (local >= 0) & (local < chunk)
        # clip (NOT where-redirect): clipping preserves monotonicity so the
        # scatter keeps its sorted-indices fast path — measured 14 vs 36
        # ns/row at 131k rows for clip+hint vs redirect+no-hint
        blk = jnp.zeros((chunk, d), srows.dtype).at[
            jnp.clip(local, 0, chunk - 1)
        ].add(jnp.where(valid[:, None], wrow, 0.0), indices_are_sorted=True)
        blocks.append(blk)
    g = jnp.concatenate(blocks, axis=0)[:vocab_rows]

    applied = _applied_mask(sid, bounds, offs, chunk, window)
    n_missing = jnp.sum(~applied)

    def with_fallback(g_):
        rest = jnp.where(applied[:, None], 0.0, srows)
        return g_.at[sid].add(rest, mode="drop", indices_are_sorted=True)

    return jax.lax.cond(n_missing > 0, with_fallback, lambda g_: g_, g)


def gather_sorted(
    table: jax.Array,
    sid: jax.Array,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
) -> jax.Array:
    """``rows[j] = table[sid[j]]`` with sid SORTED; chunk-sliced fast path.

    sid must be in [0, table rows).  Exact for any input (fallback blends a
    direct gather for window-overflow occurrences).
    """
    m = sid.shape[0]
    vocab_rows, d = table.shape
    if vocab_rows < MIN_ROWS_TO_CHUNK or m <= window:
        return jnp.take(table, sid, axis=0)
    nchunks = -(-vocab_rows // chunk)
    bounds = _bounds(sid, vocab_rows, chunk)
    offs = _window_offsets(bounds, m, window)

    out = jnp.zeros((m, d), table.dtype)
    for c in range(nchunks):
        off = offs[c]
        wid = jax.lax.dynamic_slice(sid, (off,), (window,))
        local = wid - c * chunk
        valid = (local >= 0) & (local < chunk)
        rows_c = vocab_rows - c * chunk
        tchunk = jax.lax.dynamic_slice(
            table, (c * chunk, 0), (min(chunk, rows_c), d)
        )
        got = jnp.take(tchunk, jnp.clip(local, 0, tchunk.shape[0] - 1), axis=0)
        # blend into the current window region without clobbering rows other
        # chunks own (windows can overlap when clamped near the array ends)
        cur = jax.lax.dynamic_slice(out, (off, 0), (window, d))
        blended = jnp.where(valid[:, None], got, cur)
        out = jax.lax.dynamic_update_slice(out, blended, (off, 0))

    applied = _applied_mask(sid, bounds, offs, chunk, window)
    n_missing = jnp.sum(~applied)

    def with_fallback(out_):
        direct = jnp.take(table, sid, axis=0)
        return jnp.where(applied[:, None], out_, direct)

    return jax.lax.cond(n_missing > 0, with_fallback, lambda o: o, out)
