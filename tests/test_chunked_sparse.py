"""Chunked gather/densify vs direct oracles (ops/chunked_sparse.py).

Covers: uniform ids, heavy skew (hot id repeated beyond the window ->
exercises the exact fallback branch), pad-at-end, tiny windows, and the
below-threshold passthrough.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from deepctr_tpu.ops.chunked_sparse import densify_sorted, gather_sorted

V = 300_000  # above MIN_ROWS_TO_CHUNK
D = 5


def _oracle_densify(ids, rows, v):
    g = np.zeros((v, rows.shape[1]), np.float32)
    np.add.at(g, ids, rows)
    return g


def _make(ids_np, seed=0):
    rng = np.random.default_rng(seed)
    ids_np = np.sort(ids_np.astype(np.int32))
    rows_np = rng.normal(size=(len(ids_np), D)).astype(np.float32)
    return ids_np, rows_np


CASES = {
    "uniform": lambda rng: rng.integers(0, V, 4096),
    "skew_hot": lambda rng: np.concatenate(
        [np.full(3000, 7, np.int64), rng.integers(0, V, 1096)]
    ),
    "all_one_chunk": lambda rng: rng.integers(1000, 2000, 4096),
    "ends": lambda rng: np.concatenate(
        [np.zeros(100, np.int64), np.full(100, V - 1, np.int64),
         rng.integers(0, V, 3896)]
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("window", [512, 8192])
def test_densify_matches_oracle(case, window):
    rng = np.random.default_rng(1)
    ids_np, rows_np = _make(CASES[case](rng))
    got = np.asarray(
        densify_sorted(jnp.asarray(ids_np), jnp.asarray(rows_np), V,
                       chunk=65_536, window=window)
    )
    want = _oracle_densify(ids_np, rows_np, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("window", [512, 8192])
def test_gather_matches_oracle(case, window):
    rng = np.random.default_rng(2)
    ids_np, _ = _make(CASES[case](rng))
    table = rng.normal(size=(V, D)).astype(np.float32)
    got = np.asarray(
        gather_sorted(jnp.asarray(table), jnp.asarray(ids_np),
                      chunk=65_536, window=window)
    )
    np.testing.assert_allclose(got, table[ids_np], rtol=1e-6, atol=1e-6)


def test_small_table_passthrough():
    rng = np.random.default_rng(3)
    v = 1000
    ids_np = np.sort(rng.integers(0, v, 256).astype(np.int32))
    rows_np = rng.normal(size=(256, D)).astype(np.float32)
    got = np.asarray(densify_sorted(jnp.asarray(ids_np), jnp.asarray(rows_np), v))
    np.testing.assert_allclose(got, _oracle_densify(ids_np, rows_np, v),
                               rtol=1e-5, atol=1e-5)
    table = rng.normal(size=(v, D)).astype(np.float32)
    got = np.asarray(gather_sorted(jnp.asarray(table), jnp.asarray(ids_np)))
    np.testing.assert_allclose(got, table[ids_np], rtol=1e-6, atol=1e-6)
