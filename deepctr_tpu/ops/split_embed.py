"""Split embedding execution: one-hot-matmul for small fields, gather for big.

Motivation: gather and scatter-add cost is per row, and scatter-add must
combine duplicate ids.  A CTR schema is dominated by *small-vocabulary*
fields (weekday=8, hour=25, city=400, ... — 15 of 18 iPinYou slots) whose
embedding rows can instead be produced as ``onehot(ids) @ subtable`` — a few
hundred MFLOPs of matmul — whose autodiff backward is the *dense* per-field
gradient ``onehotᵀ @ g`` (the exact duplicate-summed gradient the sparse
optimizer needs) with **zero scatter rows**.  Only the few huge fields
(domain, url, slotid at iPinYou scale) keep the take + scatter-add path.
The path was chosen on the previous accelerator; whether it pays on the GPU
in every cell is still to be measured.

Semantics are identical to the all-scatter path:

- duplicate ids within a field/batch are summed into one per-row gradient
  before the optimizer update (the one-hot matmul sums them by construction);
- pad slots (``id == schema.pad_id``) fall outside every field's local range,
  so their one-hot row is all-zero: the forward contribution is the zero row
  (same as the frozen pad row) and no gradient flows to any table row.

Reference parity: this replaces the Theano ``inc_subtensor`` sparse-update
machinery (SURVEY.md C10) for small fields with a matmul formulation; the
training math is unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..data.schema import Schema

# Default vocab-size cutoff between the one-hot-matmul path and take+scatter:
# 8192 keeps the one-hot temporaries modest (see MEMORY below).  Where the
# two paths cross on the GPU is still to be measured.
#
# Precision of the one-hot selection matmuls.  HIGHEST (full f32; on the GPU
# this runs outside the tensor cores) keeps the split path trajectory-equal
# to the all-scatter path: the selection itself is exact at any precision,
# but the backward's summed per-field gradient is where precision matters —
# a lower precision rounds the operands (TF32 keeps a 10-bit mantissa, bf16
# 7 bits).  Module-level so benchmarks can trade that gradient rounding for
# matmul throughput.
ONEHOT_PRECISION = jax.lax.Precision.HIGHEST

# MEMORY: each small slot materialises a [B, L, vocab] f32 one-hot temporary
# (usually fused into the matmul by XLA, but budget for it): at batch 8192 a
# vocab-8192 single-slot field is ~256 MB.  iPinYou-shaped schemas (small
# vocabs <= 7k spread over many fields) are safe; for schemas with several
# near-threshold fields lower ``threshold`` (CLI: ``train.split_threshold``)
# so that ``batch * max_len * vocab * 4`` stays within device-memory headroom.
DEFAULT_THRESHOLD = 8192


@dataclasses.dataclass(frozen=True)
class SmallField:
    name: str
    offset: int      # first global id of the field
    vocab: int       # field vocab size
    slot_start: int  # first packed slot
    slot_len: int    # number of packed slots (max_len)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Static partition of a schema's slots into matmul / gather classes."""

    small: tuple[SmallField, ...]
    big_slots: tuple[int, ...]    # packed slot indices using take+scatter
    num_slots: int

    @property
    def has_small(self) -> bool:
        return bool(self.small)

    @property
    def perm_to_slots(self) -> np.ndarray:
        """int32[S] permutation mapping [small-major-concat | big] -> slot order.

        ``assemble_rows`` builds rows as [all small fields' slots in schema
        order, then big slots]; this permutation restores packed slot order.
        """
        order = [
            s
            for f in self.small
            for s in range(f.slot_start, f.slot_start + f.slot_len)
        ] + list(self.big_slots)
        inv = np.empty(len(order), np.int32)
        for pos, slot in enumerate(order):
            inv[slot] = pos
        return inv


def make_split_plan(schema: Schema, threshold: int = DEFAULT_THRESHOLD) -> SplitPlan:
    """Partition fields: vocab <= threshold -> one-hot matmul, else gather."""
    small: list[SmallField] = []
    big_slots: list[int] = []
    slot = 0
    for f, off in zip(schema.fields, schema.offsets):
        if f.vocab_size <= threshold:
            small.append(
                SmallField(f.name, int(off), f.vocab_size, slot, f.max_len)
            )
        else:
            big_slots.extend(range(slot, slot + f.max_len))
        slot += f.max_len
    return SplitPlan(
        small=tuple(small), big_slots=tuple(big_slots), num_slots=slot
    )


def slice_small_tables(table: jax.Array, plan: SplitPlan) -> list[jax.Array]:
    """Static [vocab, D] slices of the flat table, one per small field.

    Sliced OUTSIDE the loss so autodiff produces dense per-field gradients
    (differentiating through ``dynamic_slice`` w.r.t. the full table would
    materialise a [V, D] zero-padded gradient per field).
    """
    d = table.shape[1]
    return [
        jax.lax.dynamic_slice(table, (f.offset, 0), (f.vocab, d))
        for f in plan.small
    ]


def gather_big_rows(table: jax.Array, ids: jax.Array, plan: SplitPlan) -> jax.Array:
    """[B, n_big_slots, D] rows for the gather-class slots (global ids)."""
    if not plan.big_slots:
        b = ids.shape[0]
        return jnp.zeros((b, 0, table.shape[1]), table.dtype)
    return jnp.take(table, ids[:, jnp.asarray(plan.big_slots)], axis=0)


def gather_big_rows_sorted(
    table: jax.Array, ids: jax.Array, plan: SplitPlan
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Sorted-index gather for the big slots: sort ids, take, un-permute.

    Sorting the indices lets the table gather (and the optimizer's
    scatter-add) run over ascending rows; the two auxiliary permutation
    gathers operate on the small [N, D] occurrence array, and the id/payload
    sort is a single variadic ``lax.sort``.  Whether the sort pays for
    itself on the GPU is still to be measured.

    Returns ``(rows [B, nb, D], sorted_ids [B*nb], order [B*nb])``: the
    training step scatters the big-field row gradients with
    ``occ_ids=sorted_ids, occ_rows=g_big.reshape(-1, D)[order]`` so the
    optimizer's scatter-add can claim ``indices_are_sorted`` too.
    """
    b = ids.shape[0]
    d = table.shape[1]
    if not plan.big_slots:
        empty = jnp.zeros((0,), jnp.int32)
        return jnp.zeros((b, 0, d), table.dtype), empty, empty
    flat = ids[:, jnp.asarray(plan.big_slots)].reshape(-1)
    iota = jnp.arange(flat.shape[0], dtype=jnp.int32)
    sid, order = jax.lax.sort((flat, iota), num_keys=1)
    _, inv = jax.lax.sort((order, iota), num_keys=1)
    rows_sorted = jnp.take(table, sid, axis=0)
    rows = jnp.take(rows_sorted, inv, axis=0)
    return rows.reshape(b, len(plan.big_slots), d), sid, order


def assemble_rows(
    small_tables: list[jax.Array],
    big_rows: jax.Array,
    ids: jax.Array,
    plan: SplitPlan,
    small_id_vectors: list[jax.Array] | None = None,
) -> jax.Array:
    """Assemble [B, S, D] embedding rows in packed slot order.

    Small fields: ``onehot(local_ids) @ subtable`` (pad/out-of-range local ids
    give a zero one-hot row -> zero embedding, matching the frozen pad row).
    Differentiable w.r.t. ``small_tables`` (dense [vocab, D] cotangents) and
    ``big_rows`` (per-occurrence cotangents).

    ``small_id_vectors`` (optional) gives, per small field, the local feature
    id stored at each row of that field's (possibly permuted / padded)
    subtable — the one-hot compares against it instead of ``arange(vocab)``.
    Used by the sharded path, where subtables are all-gathered shard slices
    in shard-major order; out-of-field rows carry an id outside [0, vocab)
    and so never match.
    """
    parts = []
    # the scope names these ops (and their backward) in the compiled HLO's
    # metadata, which tools/tower_share.py groups trace events by
    with jax.named_scope("onehot_lookup"):
        for i, (f, sub) in enumerate(zip(plan.small, small_tables)):
            sl = ids[:, f.slot_start : f.slot_start + f.slot_len]
            local = sl - f.offset  # [B, L]
            id_vec = (
                jnp.arange(f.vocab)
                if small_id_vectors is None
                else small_id_vectors[i]
            )
            oh = (local[..., None] == id_vec[None, None, :]).astype(sub.dtype)
            parts.append(
                jnp.einsum("blv,vd->bld", oh, sub, precision=ONEHOT_PRECISION)
            )
    parts.append(big_rows)
    rows = jnp.concatenate(parts, axis=1)
    perm = jnp.asarray(plan.perm_to_slots)
    return rows[:, perm, :]


def grads_to_patches(
    small_table_grads: list[jax.Array], plan: SplitPlan
) -> list[tuple[int, jax.Array]]:
    """Pair each dense per-field gradient with its table row offset.

    Fields occupying CONTIGUOUS table ranges are concatenated into one span
    patch: an iPinYou-shaped schema has its 13 small fields in two contiguous
    runs (either side of the domain/url/slotid block), so the optimizer
    applies 2 slice updates instead of 13 — the concat is a few-KB copy that
    saves 11 per-field dynamic-slice round trips.
    """
    spans: list[tuple[int, list[jax.Array], int]] = []  # (offset, grads, rows)
    for f, g in zip(plan.small, small_table_grads):
        if spans and spans[-1][0] + spans[-1][2] == f.offset:
            spans[-1][1].append(g)
            spans[-1] = (spans[-1][0], spans[-1][1], spans[-1][2] + f.vocab)
        else:
            spans.append((f.offset, [g], f.vocab))
    return [
        (off, gs[0] if len(gs) == 1 else jnp.concatenate(gs, axis=0))
        for off, gs, _ in spans
    ]
