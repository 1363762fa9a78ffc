"""Jitted train/eval step builders — the reference's compiled-function
boundary, redesigned for XLA.

Reference parity: SURVEY.md §3.1 — the reference's hot loop calls a compiled
Theano ``train_fn(idx_batch, y)`` per minibatch (graph: gather -> forward ->
xent -> T.grad -> SGD with sparse ``inc_subtensor`` updates).  Here the
whole step — gather, forward, backward, deduplicated sparse table update,
dense optimizer update — is ONE ``jax.jit`` program, traced once per shape.

Key structural difference from a naive port: the loss is differentiated
w.r.t. the **gathered rows** (shape [B, S, D]) and the dense pytree, never
w.r.t. the [V, D] table, so no dense table-gradient exists at any point and
the table update costs O(batch) regardless of vocab size.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..data.schema import Schema
from ..models.base import Model, lazy_l2, weighted_bce_with_logits
from ..ops.split_embed import (
    SplitPlan,
    assemble_rows,
    gather_big_rows,
    gather_big_rows_sorted,
    grads_to_patches,
    slice_small_tables,
)
from ..optim.sparse import SparseAdagrad, SparseSgd


class TrainState(NamedTuple):
    step: jax.Array          # int32 scalar
    table: jax.Array         # [V+1, D]
    sparse_state: Any
    dense: Any
    dense_state: Any
    rng: jax.Array


class StepMetrics(NamedTuple):
    loss: jax.Array
    logits: jax.Array


def init_state(
    model: Model,
    schema: Schema,
    sparse_opt,
    dense_opt,
    seed: int = 0,
    table_dtype: str = "f32",
) -> TrainState:
    """``table_dtype="bf16"`` stores the embedding table in bfloat16 (the
    device-memory bandwidth knob): gathers and the full-table
    Adagrad elementwise stream half the bytes; all math stays f32 (rows are
    cast after the gather, updates are computed f32 and rounded on write;
    the Adagrad accumulator stays f32 — its increments are far below bf16
    ulp and would stagnate)."""
    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    params = model.init_params(init_rng, schema)
    table = params["table"]
    if table_dtype == "bf16":
        table = table.astype(jnp.bfloat16)
    elif table_dtype != "f32":
        raise ValueError(f"table_dtype {table_dtype!r} (f32|bf16)")
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        table=table,
        sparse_state=sparse_opt.init(table),
        dense=params["dense"],
        dense_state=dense_opt.init(params["dense"]),
        rng=rng,
    )


def make_train_step(
    model: Model,
    schema: Schema,
    sparse_opt,
    dense_opt,
    l2: float = 0.0,
    jit: bool = True,
    split: SplitPlan | None = None,
):
    """Build ``step(state, ids, labels, weights) -> (state, metrics)``.

    ``split`` (ops/split_embed.py) routes small-vocabulary fields through a
    differentiable one-hot matmul — their gradients arrive as dense per-field
    patches with zero scatter rows — while big fields keep take + scatter.
    Training math is identical either way (property-tested).
    """
    pad_id = schema.pad_id

    def step(state: TrainState, ids, labels, weights, lr_scale=1.0):
        rng, step_rng = jax.random.split(state.rng)
        mask = (ids != pad_id).astype(jnp.float32)

        if split is not None and split.has_small:
            # cast-early: with a bf16-stored table the small subtables (a few
            # hundred KB) and the gathered big rows are promoted to f32 right
            # after the memory-bound reads, so every downstream op (one-hot
            # einsums, tower, grads) sees the f32-mode graph (no-op for f32)
            small_tabs = [
                t.astype(jnp.float32)
                for t in slice_small_tables(state.table, split)
            ]
            big_rows, sorted_ids, order = gather_big_rows_sorted(
                state.table, ids, split
            )
            big_rows = big_rows.astype(jnp.float32)

            def loss_fn(small_tabs_, big_rows_, dense_):
                rows_ = assemble_rows(small_tabs_, big_rows_, ids, split)
                logits = model.apply_rows(
                    dense_, rows_, mask, train=True, rng=step_rng
                )
                loss = weighted_bce_with_logits(logits, labels, weights)
                loss = loss + lazy_l2(rows_, mask, l2)
                return loss, logits

            (loss, logits), (g_small, g_big, g_dense) = jax.value_and_grad(
                loss_fn, argnums=(0, 1, 2), has_aux=True
            )(small_tabs, big_rows, state.dense)
            # scatter the big-field row grads in sorted-id order (the fwd
            # gather already paid for the sort) so the optimizer's
            # scatter-add takes XLA's faster sorted path
            occ_ids = sorted_ids
            occ_rows = jnp.take(g_big.reshape(-1, g_big.shape[-1]), order, axis=0)
            patches = grads_to_patches(g_small, split)
            ids_sorted = True
        else:
            rows = jnp.take(state.table, ids, axis=0).astype(
                jnp.float32
            )  # [B, S, D]

            def loss_fn(rows_, dense_):
                logits = model.apply_rows(
                    dense_, rows_, mask, train=True, rng=step_rng
                )
                loss = weighted_bce_with_logits(logits, labels, weights)
                loss = loss + lazy_l2(rows_, mask, l2)
                return loss, logits

            (loss, logits), (g_rows, g_dense) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True
            )(rows, state.dense)
            occ_ids = ids.reshape(-1)
            occ_rows = g_rows.reshape(-1, g_rows.shape[-1])
            patches = ()
            ids_sorted = False

        table, sparse_state = sparse_opt.update(
            state.table,
            state.sparse_state,
            occ_ids,
            occ_rows,
            lr_scale=lr_scale,
            patches=patches,
            ids_sorted=ids_sorted,
        )
        updates, dense_state = dense_opt.update(g_dense, state.dense_state, state.dense)
        # the reference decays its learning rate over epochs (SURVEY.md §3.1
        # "early stop / LR decay"); lr_scale applies uniformly to both sides
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        dense = optax.apply_updates(state.dense, updates)
        new_state = TrainState(
            step=state.step + 1,
            table=table,
            sparse_state=sparse_state,
            dense=dense,
            dense_state=dense_state,
            rng=rng,
        )
        return new_state, StepMetrics(loss=loss, logits=logits)

    if jit:
        step = jax.jit(step, donate_argnums=(0,))
    return step


def make_scan_train_step(
    model: Model,
    schema: Schema,
    sparse_opt,
    dense_opt,
    l2: float = 0.0,
    split: SplitPlan | None = None,
):
    """Multi-step trainer: one jitted ``lax.scan`` over T stacked batches.

    ``scan_step(state, ids [T,B,S], labels [T,B], weights [T,B])``
    -> ``(state, losses [T])``.

    Rationale: the reference drives one compiled call per minibatch from
    Python (SURVEY.md §3.1).  Scanning T steps inside one XLA program
    amortises the per-dispatch host cost over T steps.  That this cost
    matters on a locally attached GPU (and so the default T=8 of
    ``train.scan_steps``) is a claim still to be measured against a trace.
    """
    inner = make_train_step(
        model, schema, sparse_opt, dense_opt, l2=l2, jit=False, split=split
    )

    def scan_step(state: TrainState, ids, labels, weights, lr_scale=1.0):
        def body(st, batch):
            st2, m = inner(st, *batch, lr_scale)
            return st2, m.loss

        state, losses = jax.lax.scan(body, state, (ids, labels, weights))
        return state, losses

    return jax.jit(scan_step, donate_argnums=(0,))


def make_eval_step(
    model: Model, schema: Schema, jit: bool = True, split: SplitPlan | None = None
):
    """Build ``eval_step(table, dense, ids) -> logits`` (no dropout)."""
    pad_id = schema.pad_id

    def eval_step(table, dense, ids):
        mask = (ids != pad_id).astype(jnp.float32)
        if split is not None and split.has_small:
            rows = assemble_rows(
                [t.astype(jnp.float32)
                 for t in slice_small_tables(table, split)],
                gather_big_rows_sorted(table, ids, split)[0].astype(
                    jnp.float32
                ),
                ids,
                split,
            )
        else:
            rows = jnp.take(table, ids, axis=0).astype(jnp.float32)
        return model.apply_rows(dense, rows, mask, train=False, rng=None)

    if jit:
        eval_step = jax.jit(eval_step)
    return eval_step


# ---------------------------------------------------------------------------
# SNN unsupervised pretraining step (shared by DAE and RBM)
# ---------------------------------------------------------------------------


def make_pretrain_step(
    pretrainer,
    schema: Schema,
    sparse_opt,
    dense_lr: float,
    jit: bool = True,
    with_noise: bool = False,
):
    """Build ``pstep(table, sparse_state, dense, rng, ids) -> (...)`` where
    dense = {"b1", "vbias"} (init_pretrain_dense).  vbias is updated with
    plain SGD through a deduplicated sparse scatter as well.

    ``with_noise=True`` builds the matched-noise variant
    ``pstep(table, sparse_state, dense, rng, ids, noise)`` where ``noise``
    is the pretrainer's uniform-draw dict — feeding the SAME uniforms here
    and to the NumPy oracle makes the two pretraining trajectories directly
    comparable (tests/test_pretrain.py, PARITY.md 'pretrain-matched')."""
    from ..models.snn import field_sampling
    from ..ops.scatter import scatter_add_dedup

    fs = field_sampling(schema)
    pad_id = schema.pad_id

    def pstep(table, sparse_state, dense, rng, ids, noise=None):
        rng, sub = jax.random.split(rng)
        loss, occ_ids, occ_rows, dgrads = pretrainer.loss_and_grads(
            table, dense, ids, pad_id, fs, sub, noise=noise
        )
        table, sparse_state = sparse_opt.update(table, sparse_state, occ_ids, occ_rows)
        vbias = scatter_add_dedup(
            dense["vbias"][:, None],
            dgrads["vbias_ids"],
            -dense_lr * dgrads["vbias_grads"][:, None],
        )[:, 0]
        dense = {"b1": dense["b1"] - dense_lr * dgrads["b1"], "vbias": vbias}
        return table, sparse_state, dense, rng, loss

    if not with_noise:
        base = pstep

        def pstep(table, sparse_state, dense, rng, ids):  # noqa: F811
            return base(table, sparse_state, dense, rng, ids)

    if jit:
        pstep = jax.jit(pstep, donate_argnums=(0, 1, 2))
    return pstep
