"""Sparse per-row optimizers for embedding tables.

Reference parity: the reference's SGD/Adagrad touch only the embedding rows
active in each minibatch via Theano indexed updates (SURVEY.md C10,
BASELINE.json:5).  Semantics here are identical: duplicate ids in a batch
are summed into one per-row gradient BEFORE the update rule (the Adagrad
accumulator sees ``(sum_i g_i)^2``, not ``sum_i g_i^2``).

Two execution strategies, chosen per table size (``mode="auto"``):

- **dense** (tables that fit a [V, D] scratch, i.e. almost everything up to
  multi-million-row vocabs): one XLA scatter-add builds the per-row summed
  gradient G, then the update is a full-table elementwise op.  G is zero on
  untouched rows so they are bit-identical unchanged; the cost is a few
  table-sized memory streams.
- **sorted** (giant tables, e.g. Criteo-scale hash spaces where a
  [V, D] f32 scratch is >buffer budget): stable-sort occurrence ids and run
  a segmented inclusive scan (deepctr_tpu.ops.scatter) so each distinct
  id's total lands on its last occurrence; cost is O(M log M), independent
  of vocab size, and no dense temporary is ever materialised.

Plain SGD needs no dedup at all (scatter-add is associative), so it is a
single sorted scatter-add in either mode.

Both optimizers additionally accept ``patches`` — a list of
``(row_offset, G_f)`` pairs carrying already-deduplicated **dense**
per-field gradients for contiguous table ranges.  These come from the
split-embedding path (ops/split_embed.py), where small-vocabulary fields
compute their gradient as a one-hot matmul instead of contributing scatter
rows; each patch is applied as a static-slice elementwise update (pure
bandwidth, no scatter).  Patch ranges and occurrence ids never overlap (a
field is in exactly one class), so ordering is immaterial.

The padding row stays frozen as long as its occurrence gradients are zero —
guaranteed by the models masking pad slots in the forward pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.scatter import dedupe_grads

# tables up to this many elements use the dense-scratch strategy in "auto"
_DENSE_AUTO_LIMIT = 64 * 1024 * 1024


class SparseSgdState(NamedTuple):
    pass


class SparseAdagradState(NamedTuple):
    acc: jax.Array  # per-coordinate accumulator, same shape as the table


def _pick_dense(mode: str, table: jax.Array) -> bool:
    if mode == "dense":
        return True
    if mode == "sorted":
        return False
    return table.size <= _DENSE_AUTO_LIMIT


@dataclasses.dataclass(frozen=True)
class SparseSgd:
    """Plain SGD on touched rows: ``row -= lr * sum_of_row_grads``."""

    learning_rate: float

    def init(self, table: jax.Array) -> SparseSgdState:
        del table
        return SparseSgdState()

    def update(
        self,
        table: jax.Array,
        state: SparseSgdState,
        ids: jax.Array,
        rows: jax.Array,
        lr_scale: jax.Array | float = 1.0,
        patches=(),
        ids_sorted: bool = False,
    ) -> tuple[jax.Array, SparseSgdState]:
        lr = self.learning_rate * lr_scale
        # scatter-add sums duplicates natively; no dedup pass needed.
        # bf16-stored tables (init_state table_dtype): the delta is computed
        # f32 and rounded on write
        new_table = table.at[ids].add(
            (-lr * rows).astype(table.dtype), indices_are_sorted=ids_sorted
        )
        for off, g in patches:
            d = table.shape[1]
            cur = jax.lax.dynamic_slice(new_table, (off, 0), (g.shape[0], d))
            upd = (cur.astype(jnp.float32) - lr * g).astype(table.dtype)
            new_table = jax.lax.dynamic_update_slice(new_table, upd, (off, 0))
        return new_table, state


@dataclasses.dataclass(frozen=True)
class SparseAdagrad:
    """Per-coordinate Adagrad on touched rows.

    acc[i] += g_i^2 ; row_i -= lr * g_i / (sqrt(acc[i]) + eps)
    with g_i the per-row gradient summed over batch occurrences.
    """

    learning_rate: float
    eps: float = 1e-6
    initial_accumulator: float = 0.0
    mode: str = "auto"  # auto | dense | sorted
    # dtype of the dense-mode gradient scratch G: bf16 halves the scatter's
    # write stream and the elementwise's read of G, at the cost of bf16
    # rounding in the duplicate-id accumulation (default keeps exact f32)
    scratch_dtype: str = "f32"  # f32 | bf16

    def init(self, table: jax.Array) -> SparseAdagradState:
        return SparseAdagradState(
            acc=jnp.full(table.shape, self.initial_accumulator, dtype=jnp.float32)
        )

    def update(
        self,
        table: jax.Array,
        state: SparseAdagradState,
        ids: jax.Array,
        rows: jax.Array,
        lr_scale: jax.Array | float = 1.0,
        patches=(),
        ids_sorted: bool = False,
    ) -> tuple[jax.Array, SparseAdagradState]:
        lr = self.learning_rate * lr_scale
        if _pick_dense(self.mode, table):
            # G scratch defaults to f32 even for bf16-stored tables: the
            # duplicate-summed gradient and the accumulator math must not
            # round (acc increments sit far below bf16 ulp); only the table
            # write rounds (one cast, fused into the same elementwise loop).
            # scratch_dtype="bf16" is the lower-traffic variant.
            sdt = jnp.bfloat16 if self.scratch_dtype == "bf16" else jnp.float32
            g = jnp.zeros(table.shape, sdt).at[ids].add(
                rows.astype(sdt), indices_are_sorted=ids_sorted
            ).astype(jnp.float32)
            acc = state.acc + g * g
            new_table = (
                table.astype(jnp.float32) - lr * g / (jnp.sqrt(acc) + self.eps)
            ).astype(table.dtype)
        else:
            d = dedupe_grads(ids, rows, ids_sorted=ids_sorted)
            g2 = d.rows * d.rows
            acc = state.acc.at[d.ids].add(g2, indices_are_sorted=True)
            denom = jnp.sqrt(acc[d.ids]) + self.eps
            delta = -lr * d.rows / denom
            new_table = table.at[d.ids].add(
                delta.astype(table.dtype), indices_are_sorted=True
            )
        # dense per-field patches: slice-wise elementwise updates.  Patch rows
        # receive no occurrence gradient above (disjoint id ranges), so acc and
        # table are untouched there before the patch applies.
        ddim = table.shape[1]
        for off, gf in patches:
            vf = gf.shape[0]
            acc_f = jax.lax.dynamic_slice(acc, (off, 0), (vf, ddim)) + gf * gf
            tab_f = jax.lax.dynamic_slice(new_table, (off, 0), (vf, ddim))
            tab_f = (
                tab_f.astype(jnp.float32) - lr * gf / (jnp.sqrt(acc_f) + self.eps)
            ).astype(new_table.dtype)
            acc = jax.lax.dynamic_update_slice(acc, acc_f, (off, 0))
            new_table = jax.lax.dynamic_update_slice(new_table, tab_f, (off, 0))
        return new_table, SparseAdagradState(acc=acc)


def make_sparse_optimizer(name: str, learning_rate: float, **kw):
    name = name.lower()
    if name == "sgd":
        return SparseSgd(learning_rate)
    if name == "adagrad":
        return SparseAdagrad(learning_rate, **kw)
    raise ValueError(f"unknown sparse optimizer {name!r} (sgd|adagrad)")
