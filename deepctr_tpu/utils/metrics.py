"""Evaluation metrics: AUC (exact + streaming histogram), logloss, RMSE.

Reference parity: component C9 (SURVEY.md §2.1) — the reference evaluates
per-epoch AUC via sklearn plus hand-rolled logloss/RMSE.  Addition (SURVEY.md §5 observability row): a streaming, on-device AUC from
fixed-bin score histograms, so evaluation over a sharded dataset is one
``psum`` of two [num_bins] vectors instead of gathering every score to host.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def exact_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC-AUC via rank statistic (ties handled by midranks).

    Equivalent to sklearn.roc_auc_score; implemented directly so the metric
    has no dependency on sklearn's availability at serving time.
    """
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    y = labels[order]
    # midranks for ties
    n = len(s)
    ranks = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        ranks[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    npos = y.sum()
    nneg = n - npos
    if npos == 0 or nneg == 0:
        return float("nan")
    return float((ranks[y == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def logloss(labels: np.ndarray, probs: np.ndarray, eps: float = 1e-7) -> float:
    p = np.clip(np.asarray(probs, np.float64), eps, 1 - eps)
    y = np.asarray(labels, np.float64)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def rmse(labels: np.ndarray, probs: np.ndarray) -> float:
    d = np.asarray(probs, np.float64) - np.asarray(labels, np.float64)
    return float(np.sqrt((d * d).mean()))


# ---------------------------------------------------------------------------
# Streaming on-device AUC
# ---------------------------------------------------------------------------


class AucState(NamedTuple):
    """Histogram of sigmoid scores per class. Addable across batches/devices
    (a ``psum`` over devices merges shards)."""

    pos: jax.Array  # f32[num_bins]
    neg: jax.Array  # f32[num_bins]


def auc_state_init(num_bins: int = 4096) -> AucState:
    return AucState(
        pos=jnp.zeros((num_bins,), jnp.float32),
        neg=jnp.zeros((num_bins,), jnp.float32),
    )


def auc_state_update(
    state: AucState, logits: jax.Array, labels: jax.Array, weights: jax.Array
) -> AucState:
    """Accumulate a batch. Bins are uniform in sigmoid(score) in [0, 1]."""
    nb = state.pos.shape[0]
    p = jax.nn.sigmoid(logits)
    idx = jnp.clip((p * nb).astype(jnp.int32), 0, nb - 1)
    wpos = weights * labels
    wneg = weights * (1.0 - labels)
    pos = state.pos.at[idx].add(wpos)
    neg = state.neg.at[idx].add(wneg)
    return AucState(pos=pos, neg=neg)


def auc_state_finalize(state: AucState) -> float:
    """AUC from histograms: P(score_pos > score_neg) + 0.5 P(equal-bin)."""
    pos = np.asarray(state.pos, np.float64)
    neg = np.asarray(state.neg, np.float64)
    npos, nneg = pos.sum(), neg.sum()
    if npos == 0 or nneg == 0:
        return float("nan")
    cneg = np.cumsum(neg)  # negatives in bins <= b
    wins = (pos * (cneg - neg)).sum()   # strictly lower bins
    ties = (pos * neg).sum()
    return float((wins + 0.5 * ties) / (npos * nneg))
