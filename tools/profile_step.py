"""Break down the FNN full-vocab train step into component device costs.

Uses the marginal T vs 2T lax.scan protocol (ARCHITECTURE.md §6): each
component runs inside a scan whose carry forces sequential dependence, and
we report (time(2T) - time(T)) / T.
"""

import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial


B = 8192
S = 16
D = 11
V = 937_670  # full-iPinYou-scale vocab
T = 8


def marginal(run):
    run(T)
    run(2 * T)
    a = run(T)
    b = run(2 * T)
    return max(b - a, 1e-9) / T


def timer(fn, *args):
    """fn jitted over scan already; returns closure run(c)->seconds."""
    def run(c):
        t0 = time.perf_counter()
        out = fn(c, *args)
        np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
        return time.perf_counter() - t0
    return run


def main():
    key = jax.random.PRNGKey(0)
    table = jax.random.normal(key, (V + 1, D), jnp.float32)
    acc = jnp.zeros_like(table)
    ids = jax.random.randint(key, (2 * T, B, S), 0, V, jnp.int32)
    g_rows = jax.random.normal(key, (2 * T, B, S, D), jnp.float32)
    for x in (table, acc, ids, g_rows):
        x.block_until_ready()
    float(table.sum())

    rep = {}

    # 1. gather only
    @partial(jax.jit, static_argnums=0)
    def gather_scan(c, table, ids):
        def body(carry, idx):
            rows = jnp.take(table, idx, axis=0)
            return carry + rows.sum(), None
        out, _ = jax.lax.scan(body, 0.0, ids[:c])
        return out

    def g_run(c):
        t0 = time.perf_counter()
        out = gather_scan(c, table, ids)
        float(out)
        return time.perf_counter() - t0
    rep["gather_ms"] = marginal(g_run) * 1e3

    # 2. scatter-add into dense scratch (the dedup sum)
    @partial(jax.jit, static_argnums=0)
    def scatter_scan(c, table, ids, g_rows):
        def body(tbl, batch):
            idx, g = batch
            g2 = jnp.zeros_like(tbl).at[idx.reshape(-1)].add(
                g.reshape(-1, D))
            return tbl + 1e-12 * g2, None
        out, _ = jax.lax.scan(body, table, (ids[:c], g_rows[:c]))
        return out

    def s_run(c):
        t0 = time.perf_counter()
        out = scatter_scan(c, table, ids, g_rows)
        float(out[0, 0])
        return time.perf_counter() - t0
    rep["scatter_dense_ms"] = marginal(s_run) * 1e3

    # 3. full dense-mode adagrad update (scatter + elementwise streams)
    from deepctr_tpu.optim.sparse import SparseAdagrad, SparseAdagradState

    opt = SparseAdagrad(0.05, mode="dense")

    @partial(jax.jit, static_argnums=0)
    def adagrad_scan(c, table, acc, ids, g_rows):
        def body(carry, batch):
            tbl, a = carry
            idx, g = batch
            tbl, st = opt.update(tbl, SparseAdagradState(acc=a),
                                 idx.reshape(-1), g.reshape(-1, D))
            return (tbl, st.acc), None
        out, _ = jax.lax.scan(body, (table, acc), (ids[:c], g_rows[:c]))
        return out

    def a_run(c):
        t0 = time.perf_counter()
        out = adagrad_scan(c, table, acc, ids, g_rows)
        float(out[0][0, 0])
        return time.perf_counter() - t0
    rep["adagrad_dense_ms"] = marginal(a_run) * 1e3

    # 3b. sorted-mode adagrad
    opt_s = SparseAdagrad(0.05, mode="sorted")

    @partial(jax.jit, static_argnums=0)
    def adagrad_sorted_scan(c, table, acc, ids, g_rows):
        def body(carry, batch):
            tbl, a = carry
            idx, g = batch
            tbl, st = opt_s.update(tbl, SparseAdagradState(acc=a),
                                   idx.reshape(-1), g.reshape(-1, D))
            return (tbl, st.acc), None
        out, _ = jax.lax.scan(body, (table, acc), (ids[:c], g_rows[:c]))
        return out

    def as_run(c):
        t0 = time.perf_counter()
        out = adagrad_sorted_scan(c, table, acc, ids, g_rows)
        float(out[0][0, 0])
        return time.perf_counter() - t0
    rep["adagrad_sorted_ms"] = marginal(as_run) * 1e3

    # 4. dense tower fwd+bwd (no table involvement)
    from deepctr_tpu.models import make_fnn, MlpSpec
    from deepctr_tpu.data import ipinyou_like_schema

    schema = ipinyou_like_schema()
    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    params = model.init_params(jax.random.PRNGKey(1), schema)
    dense = params["dense"]
    rows = jax.random.normal(key, (B, schema.num_slots, D), jnp.float32)
    mask = jnp.ones((B, schema.num_slots), jnp.float32)
    labels = jnp.zeros((B,), jnp.float32)
    rows.block_until_ready()

    from deepctr_tpu.models.base import weighted_bce_with_logits

    @partial(jax.jit, static_argnums=0)
    def tower_scan(c, dense, rows):
        def body(carry, rng_i):
            def loss_fn(rows_, dense_):
                logits = model.apply_rows(dense_, rows_, mask, train=True,
                                          rng=jax.random.PRNGKey(0))
                return weighted_bce_with_logits(logits, labels,
                                                jnp.ones((B,), jnp.float32))
            l, (gr, gd) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
                rows + carry * 1e-12, dense)
            return l, None
        out, _ = jax.lax.scan(body, 0.0, jnp.arange(c))
        return out

    def t_run(c):
        t0 = time.perf_counter()
        out = tower_scan(c, dense, rows)
        float(out)
        return time.perf_counter() - t0
    rep["tower_fwdbwd_ms"] = marginal(t_run) * 1e3

    # 5. full train step for reference
    from deepctr_tpu.optim import SparseAdagrad as SA
    import optax
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    sopt, dopt = SA(0.05), optax.adagrad(0.02)
    # need schema whose total vocab ~= V: scale the big field
    from deepctr_tpu.data.schema import ipinyou_full_schema
    big_schema = ipinyou_full_schema()
    model2 = make_fnn(big_schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    state = init_state(model2, big_schema, sopt, dopt, seed=0)
    scan_step = make_scan_train_step(model2, big_schema, sopt, dopt)
    ids2 = np.random.default_rng(0).integers(
        0, big_schema.vocab_size, size=(2 * T, B, big_schema.num_slots)).astype(np.int32)
    ids2 = jnp.asarray(ids2)
    labels2 = jnp.zeros((2 * T, B), jnp.float32)
    w2 = jnp.ones((2 * T, B), jnp.float32)
    holder = {"state": state}

    def f_run(c):
        t0 = time.perf_counter()
        st, losses = scan_step(holder["state"], ids2[:c], labels2[:c], w2[:c])
        np.asarray(losses)
        holder["state"] = st
        return time.perf_counter() - t0
    rep["full_step_ms"] = marginal(f_run) * 1e3

    for k, v in rep.items():
        print(f"{k:24s} {v:8.3f}")


if __name__ == "__main__":
    main()
