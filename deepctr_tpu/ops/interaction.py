"""FM second-order interaction (sum-of-squares identity).

Reference parity: component C5's core math (SURVEY.md §2.3) — the pairwise
term  sum_{i<j} <v_i, v_j>  over the batch's active features, computed with
the O(N·k) identity

    1/2 * sum_f [ (sum_i v_{if})^2 - sum_i v_{if}^2 ]

instead of the O(N^2·k) double sum.  It is an elementwise-plus-reduction
chain (about 2 FLOP per byte read) that XLA fuses into one device kernel,
so it is written in plain ``jax.numpy``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fm_interaction(v_rows: jax.Array, mask: jax.Array | None = None) -> jax.Array:
    """Second-order FM term per example.

    v_rows: f32[B, S, k] gathered factor rows (pad rows zero).
    mask:   optional f32[B, S]; multiplied in if given.
    Returns f32[B].
    """
    if mask is not None:
        v_rows = v_rows * mask[..., None]
    s = v_rows.sum(axis=1)                    # [B, k]
    sq = jnp.square(v_rows).sum(axis=1)       # [B, k]
    return 0.5 * (jnp.square(s) - sq).sum(axis=1)


def fm_interaction_bruteforce(v_rows: jax.Array, mask: jax.Array | None = None) -> jax.Array:
    """O(S^2 k) oracle used by tests (SURVEY.md §4 unit-math strategy)."""
    if mask is not None:
        v_rows = v_rows * mask[..., None]
    gram = jnp.einsum("bik,bjk->bij", v_rows, v_rows)   # [B, S, S]
    upper = jnp.triu(jnp.ones(gram.shape[-2:], gram.dtype), k=1)
    return (gram * upper).sum(axis=(1, 2))
