"""Deduplicating segment-sum gradient scatter for sparse row updates.

Reference parity: component C10 (SURVEY.md §2.1) — the reference relies on
Theano ``inc_subtensor`` indexed updates so SGD touches only the embedding
rows present in the batch.  The redesign (BASELINE.json:5
"SGD/Adagrad per-row sparse updates -> segment-sum gradient scatter into
table shards") must additionally *deduplicate* repeated ids before the
optimizer math: Adagrad's accumulator update is ``acc += (sum_i g_i)^2`` per
row, which differs from ``acc += sum_i g_i^2`` when an id occurs multiple
times in a batch — so duplicates must be combined BEFORE the update rule
(SURVEY.md §7 "hard parts": "segment-sum scatter must dedupe IDs before the
update or the update rule changes semantics").

Everything here is static-shape (XLA requirement): "uniquing" M occurrence
rows is done by sorting ids and running a segmented inclusive scan; the full
per-row sum lands on the LAST occurrence of each run and every other
occurrence is zeroed.  No dense ``[vocab, dim]`` temporary is materialised —
cost is O(M log M) sort + O(M·D) scan, independent of vocab size.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class DedupedGrads(NamedTuple):
    """Occurrence-aligned deduplicated gradients.

    ids:     int32[M] sorted occurrence ids.
    rows:    f32[M, D] per-occurrence values; the TOTAL for each distinct id
             sits at that id's last occurrence, zeros elsewhere.
    is_last: bool[M] marks those last occurrences (the "unique" rows).
    """

    ids: jax.Array
    rows: jax.Array
    is_last: jax.Array


def _segmented_inclusive_sum(starts: jax.Array, values: jax.Array) -> jax.Array:
    """Inclusive segment-wise prefix sum along axis 0.

    ``starts[i]`` is True where a new segment begins.  Implemented with the
    classic (flag, value) associative operator so it lowers to a log-depth
    ``lax.associative_scan`` — no sequential loop.
    """
    flags = starts.astype(values.dtype)
    if values.ndim > 1:
        flags = flags.reshape((-1,) + (1,) * (values.ndim - 1))

    def combine(a, b):
        fa, va = a
        fb, vb = b
        # if b starts a new segment, discard a's running sum
        return jnp.maximum(fa, fb), vb + va * (1.0 - fb)

    _, out = jax.lax.associative_scan(combine, (jnp.broadcast_to(flags, values.shape), values))
    return out


def dedupe_grads(
    ids: jax.Array, rows: jax.Array, ids_sorted: bool = False
) -> DedupedGrads:
    """Combine duplicate-id gradient rows.

    ids:  int32[M] (may contain duplicates and pad ids).
    rows: f32[M, D] per-occurrence gradients.
    ids_sorted: pass True when ``ids`` is already ascending (e.g. the output
        of ``gather_big_rows_sorted``) to skip re-sorting — the forward
        already paid for the sort.

    Returns sorted ids with each distinct id's summed gradient on its last
    occurrence.  Scattering ``rows`` with ``.at[ids].add`` afterwards adds
    each distinct id's total exactly once (other occurrences add zeros), so
    optimizer math can treat last-occurrence rows as the unique row set.
    """
    if ids_sorted:
        sid, srows = ids, rows
    else:
        order = jnp.argsort(ids)
        sid = ids[order]
        srows = rows[order]
    starts = jnp.concatenate([jnp.ones((1,), bool), sid[1:] != sid[:-1]])
    summed = _segmented_inclusive_sum(starts, srows)
    is_last = jnp.concatenate([sid[1:] != sid[:-1], jnp.ones((1,), bool)])
    rows_out = jnp.where(is_last[:, None], summed, jnp.zeros_like(summed))
    return DedupedGrads(ids=sid, rows=rows_out, is_last=is_last)


def scatter_add_dedup(
    table: jax.Array, ids: jax.Array, rows: jax.Array
) -> jax.Array:
    """``table[ids] += rows`` with duplicate ids summed first.

    Equivalent to a plain scatter-add (addition is associative) but performs
    the duplicate combination in registers instead of device-memory atomics,
    and returns sorted indices to XLA (``indices_are_sorted=True``) so the
    scatter lowers to the fast sorted path.
    """
    d = dedupe_grads(ids, rows)
    return table.at[d.ids].add(d.rows, indices_are_sorted=True)


def segment_sum_dense(ids: jax.Array, rows: jax.Array, num_rows: int) -> jax.Array:
    """Oracle: dense ``[num_rows, D]`` segment sum (tests compare against it)."""
    return jax.ops.segment_sum(rows, ids, num_segments=num_rows)
