"""Training loop: epochs, per-epoch eval, early stopping.

Reference parity: SURVEY.md §3.1 hot loop — "for epoch: shuffle; for
minibatch: train_fn(...); per-epoch: pred_fn(test) -> sklearn AUC, logloss;
early stop".  Changes: the minibatch step is one jitted program;
eval streams through a jitted forward with on-host exact AUC (and an
on-device histogram AUC for sharded eval); batches are prefetched to device
on a background thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ..data.pipeline import Batch, DevicePrefetcher, minibatches
from ..data.schema import Schema
from ..models.base import Model
from ..utils import metrics as M
from ..utils.logging import MetricsLogger
from .step import TrainState, init_state, make_eval_step, make_train_step


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: list[dict]
    best_auc: float
    best_epoch: int


def evaluate(
    eval_step: Callable,
    table,
    dense,
    ids: np.ndarray,
    labels: np.ndarray,
    schema: Schema,
    batch_size: int = 8192,
) -> dict:
    """Full-dataset eval -> {auc, logloss, rmse}."""
    logits_all = []
    for b in minibatches(
        ids, labels, batch_size, schema=schema, shuffle=False, drop_remainder=False
    ):
        logits = np.asarray(eval_step(table, dense, b.ids))
        logits_all.append(logits[b.weights > 0])
    logits_np = np.concatenate(logits_all)
    probs = 1.0 / (1.0 + np.exp(-logits_np))
    return {
        "auc": M.exact_auc(labels, probs),
        "logloss": M.logloss(labels, probs),
        "rmse": M.rmse(labels, probs),
    }


def fit(
    model: Model,
    schema: Schema,
    train_ids: np.ndarray,
    train_labels: np.ndarray,
    test_ids: np.ndarray,
    test_labels: np.ndarray,
    *,
    sparse_opt,
    dense_opt,
    batch_size: int = 1024,
    epochs: int = 10,
    l2: float = 0.0,
    seed: int = 0,
    early_stop_patience: int = 2,
    lr_decay: float = 1.0,
    scan_steps: int = 0,
    split_threshold: int = 8192,
    state: TrainState | None = None,
    logger: MetricsLogger | None = None,
    prefetch: bool = True,
    on_epoch: Callable[[int, TrainState, dict], None] | None = None,
    start_epoch: int = 0,
    train_source=None,
    table_dtype: str = "f32",
) -> FitResult:
    """Train with per-epoch eval and early stop on held-out AUC.

    Mirrors the reference's training procedure (SURVEY.md §2.3: epochs over
    shuffled minibatches, per-epoch test eval, early stop on AUC).

    ``start_epoch`` (checkpoint resume) continues the epoch schedule — the
    shuffle seeds and LR decay pick up exactly where the saved run stopped,
    so kill+resume reproduces the uninterrupted trajectory bitwise.

    ``scan_steps > 1`` fuses that many minibatch steps into one jitted
    ``lax.scan`` dispatch — semantically identical training, with host
    dispatch cost amortised over the steps.

    ``train_source`` (a ``data.stream.StreamSource``) replaces the in-RAM
    ``train_ids``/``train_labels`` (pass None) with bounded-memory streaming
    from shard files — the Criteo-scale path (BASELINE.json:11).  Eval stays
    array-based (test sets are small).
    """
    from ..ops.split_embed import make_split_plan
    from .step import make_scan_train_step

    split = make_split_plan(schema, split_threshold) if split_threshold > 0 else None
    step = make_train_step(model, schema, sparse_opt, dense_opt, l2=l2, split=split)
    scan_step = (
        make_scan_train_step(
            model, schema, sparse_opt, dense_opt, l2=l2, split=split
        )
        if scan_steps > 1
        else None
    )
    eval_step = make_eval_step(model, schema, split=split)
    if state is None:
        state = init_state(model, schema, sparse_opt, dense_opt, seed=seed,
                           table_dtype=table_dtype)

    history: list[dict] = []
    best_auc, best_epoch, since_best = -np.inf, -1, 0
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        lr_scale = lr_decay**epoch
        n_batches = 0
        losses = []  # device scalars; fetched once per epoch (a float() per
        if scan_step is not None and train_source is not None:
            import jax.numpy as jnp

            from collections import deque

            it = train_source.scan_chunks(epoch, scan_steps)
            if prefetch:
                # chunk assembly + H2D staging on a background thread while
                # the device runs the previous scan dispatch — the streaming
                # path's host/device overlap (VERDICT r3 Missing #3)
                it = DevicePrefetcher(it, depth=2)
            # dispatch throttle: fetching the loss scalar of the chunk
            # W dispatches back bounds in-flight work (and therefore host
            # memory pinned by undelivered input buffers) to W chunks, so
            # the async loop cannot run arbitrarily far ahead of the
            # device.  Whether a GPU host ever gets that far ahead, and so
            # whether W=8 is the right bound, is still to be measured.
            inflight: deque = deque()
            for nb, (ids_t, y_t, w_t) in it:
                state, chunk_losses = scan_step(
                    state, jnp.asarray(ids_t), jnp.asarray(y_t),
                    jnp.asarray(w_t), lr_scale
                )
                losses.append(chunk_losses[:nb].sum())
                inflight.append(losses[-1])
                if len(inflight) > 8:
                    float(inflight.popleft())
                n_batches += nb
        elif scan_step is not None:
            import jax.numpy as jnp

            n = train_ids.shape[0]
            order = np.arange(n)
            np.random.default_rng(seed + epoch).shuffle(order)
            chunk = scan_steps * batch_size
            S = train_ids.shape[1]
            for start in range(0, n - batch_size + 1, chunk):
                sel = order[start : start + chunk]
                nb = len(sel) // batch_size          # whole batches only
                sel = sel[: nb * batch_size]
                if nb == 0:
                    break
                ids_t = train_ids[sel].reshape(nb, batch_size, S)
                y_t = train_labels[sel].reshape(nb, batch_size)
                w_t = np.ones((nb, batch_size), np.float32)
                if nb < scan_steps:  # pad to the compiled T with no-op steps
                    padb = scan_steps - nb
                    ids_t = np.concatenate(
                        [ids_t, np.full((padb, batch_size, S), schema.pad_id,
                                        np.int32)]
                    )
                    y_t = np.concatenate(
                        [y_t, np.zeros((padb, batch_size), np.float32)]
                    )
                    w_t = np.concatenate(
                        [w_t, np.zeros((padb, batch_size), np.float32)]
                    )
                state, chunk_losses = scan_step(
                    state, jnp.asarray(ids_t), jnp.asarray(y_t),
                    jnp.asarray(w_t), lr_scale
                )
                losses.append(chunk_losses[:nb].sum())
                n_batches += nb
        else:
            it = (
                train_source.batches(epoch)
                if train_source is not None
                else minibatches(
                    train_ids,
                    train_labels,
                    batch_size,
                    schema=schema,
                    shuffle=True,
                    seed=seed + epoch,
                    drop_remainder=True,
                )
            )
            if prefetch:
                it = DevicePrefetcher(it, depth=2)
            for b in it:  # step would force a host sync on every dispatch)
                state, m = step(state, b.ids, b.labels, b.weights, lr_scale)
                losses.append(m.loss)
                n_batches += 1
        import jax

        jax.block_until_ready(state.table)
        train_time = time.perf_counter() - t0
        loss_sum = float(sum(float(x) for x in losses))
        ev = evaluate(
            eval_step, state.table, state.dense, test_ids, test_labels, schema
        )
        rec = {
            "epoch": epoch,
            "train_loss": loss_sum / max(n_batches, 1),
            "examples_per_s": n_batches * batch_size / max(train_time, 1e-9),
            **ev,
        }
        history.append(rec)
        if logger is not None:
            logger.log(rec)
        if on_epoch is not None:
            on_epoch(epoch, state, rec)
        if ev["auc"] > best_auc:
            best_auc, best_epoch, since_best = ev["auc"], epoch, 0
        else:
            since_best += 1
            if since_best > early_stop_patience:
                break
    if not history:  # resumed past the epoch target: evaluate only
        ev = evaluate(
            eval_step, state.table, state.dense, test_ids, test_labels, schema
        )
        rec = {"epoch": start_epoch, "eval_only": True, **ev}
        history.append(rec)
        if logger is not None:
            logger.log(rec)
        best_auc, best_epoch = ev["auc"], start_epoch
    return FitResult(
        state=state, history=history, best_auc=float(best_auc), best_epoch=best_epoch
    )


def pretrain_snn(
    pretrainer,
    schema: Schema,
    hidden1: int,
    train_ids: np.ndarray,
    *,
    sparse_opt,
    dense_lr: float = 0.1,
    batch_size: int = 1024,
    epochs: int = 1,
    seed: int = 0,
    logger: MetricsLogger | None = None,
):
    """Unsupervised pretraining phase (SURVEY.md §3.4 phase 1).

    Returns ``(table, b1)`` to seed SNNModel's supervised phase.
    """
    import jax
    import jax.numpy as jnp

    from ..models.snn import init_pretrain_dense
    from .step import make_pretrain_step

    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    table = 0.01 * jax.random.normal(
        init_rng, (schema.padded_vocab_size, hidden1), jnp.float32
    )
    table = table.at[schema.pad_id].set(0.0)
    dense = init_pretrain_dense(schema, hidden1)
    sparse_state = sparse_opt.init(table)
    pstep = make_pretrain_step(pretrainer, schema, sparse_opt, dense_lr)

    dummy_labels = np.zeros(train_ids.shape[0], np.float32)
    for epoch in range(epochs):
        losses = []
        for b in minibatches(
            train_ids,
            dummy_labels,
            batch_size,
            schema=schema,
            shuffle=True,
            seed=seed + epoch,
            drop_remainder=True,
        ):
            table, sparse_state, dense, rng, loss = pstep(
                table, sparse_state, dense, rng, b.ids
            )
            losses.append(float(loss))
        if logger is not None:
            logger.log(
                {
                    "pretrain_epoch": epoch,
                    "pretrain_loss": float(np.mean(losses)) if losses else float("nan"),
                }
            )
    return table, dense["b1"]
