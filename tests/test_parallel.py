"""Parallelism tests on 8 fake CPU devices (SURVEY.md §4 "distributed
without a cluster"): pack/unpack layout, sharded lookup == jnp.take,
sharded training == single-device training, determinism, overflow policy."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deepctr_tpu.models import FMModel, LRModel
from deepctr_tpu.optim import SparseAdagrad, SparseSgd
from deepctr_tpu.parallel import (
    init_sharded_state,
    make_data_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    pack_table,
    shard_batch_arrays,
    unpack_table,
)
from deepctr_tpu.train.step import init_state, make_train_step


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 fake CPU devices"
    return make_data_mesh()


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    for vp in [7, 8, 16, 33]:
        logical = jnp.asarray(rng.normal(size=(vp, 3)).astype(np.float32))
        stored = pack_table(logical, 8)
        assert stored.shape[0] % 8 == 0
        back = unpack_table(stored, vp, 8)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(logical))


def test_sharded_eval_matches_dense(mesh, tiny_schema, tiny_dataset):
    model = FMModel(k=3)
    params = model.init_params(jax.random.PRNGKey(0), tiny_schema)
    ids = tiny_dataset.ids[:64]
    # dense reference
    from deepctr_tpu.models import apply_model

    want = apply_model(model, params, jnp.asarray(ids), tiny_schema.pad_id)
    # sharded
    stored = pack_table(params["table"], 8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    stored = jax.device_put(stored, NamedSharding(mesh, P("data")))
    (ids_d,) = shard_batch_arrays(mesh, ids)
    eval_step = make_sharded_eval_step(model, tiny_schema, mesh, capacity_factor=8.0)
    got = eval_step(stored, params["dense"], ids_d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_sharded_training_matches_single_device(
    opt_name, mesh, tiny_schema, tiny_dataset
):
    """The core parity check: N-way sharded training must reproduce the
    single-device trajectory (same batches, no dropout model)."""
    model = FMModel(k=3)
    if opt_name == "sgd":
        sopt = SparseSgd(0.1)
    else:
        sopt = SparseAdagrad(0.1)
    dopt = optax.sgd(0.05)

    B = 64
    steps = 5
    ds = tiny_dataset
    batches = [
        (
            ds.ids[i * B : (i + 1) * B],
            ds.labels[i * B : (i + 1) * B],
            np.ones(B, np.float32),
        )
        for i in range(steps)
    ]

    # single device
    st = init_state(model, tiny_schema, sopt, dopt, seed=3)
    table0 = np.asarray(st.table).copy()
    dense0 = jax.tree_util.tree_map(lambda x: np.asarray(x).copy(), st.dense)
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False)
    losses1 = []
    for ids, y, w in batches:
        st, m = step1(st, ids, y, w)
        losses1.append(float(m.loss))

    # sharded: same init
    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=3)
    np.testing.assert_array_equal(
        np.asarray(unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)), table0
    )
    stepN = make_sharded_train_step(model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0)
    lossesN = []
    for ids, y, w in batches:
        ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
        sst, (loss, dropped) = stepN(sst, ids_d, y_d, w_d)
        lossesN.append(float(loss))
        assert int(dropped) == 0

    np.testing.assert_allclose(losses1, lossesN, rtol=1e-4, atol=1e-5)
    tableN = np.asarray(
        unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_allclose(np.asarray(st.table), tableN, rtol=1e-4, atol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(st.dense), jax.tree_util.tree_leaves(sst.dense)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_dp_training_matches_single_device(mesh, tiny_schema, tiny_dataset):
    """GSPMD data-parallel step (replicated table, batch sharded over the
    data axis) must reproduce the single-device trajectory — the XLA SPMD
    partitioner inserts the gradient psum (SURVEY.md §2.4 DP row)."""
    from deepctr_tpu.parallel import make_dp_train_step, replicate_state

    model = FMModel(k=3)
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    B, steps = 64, 4
    ds = tiny_dataset
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(steps)
    ]

    st = init_state(model, tiny_schema, sopt, dopt, seed=3)
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False)
    losses1 = []
    for ids, y, w in batches:
        st, m = step1(st, ids, y, w)
        losses1.append(float(m.loss))

    st2 = replicate_state(
        init_state(model, tiny_schema, sopt, dopt, seed=3), mesh
    )
    dp_step = make_dp_train_step(model, tiny_schema, sopt, dopt, mesh)
    losses2 = []
    for ids, y, w in batches:
        st2, m = dp_step(st2, jnp.asarray(ids), jnp.asarray(y), jnp.asarray(w))
        losses2.append(float(m.loss))

    np.testing.assert_allclose(losses1, losses2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(st.table), np.asarray(st2.table), rtol=1e-4, atol=1e-5
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(st.dense), jax.tree_util.tree_leaves(st2.dense)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_sharded_determinism(mesh, tiny_schema, tiny_dataset):
    """Same inputs twice -> bitwise-identical tables (the determinism test
    doubling as a race check for the all-to-all path, SURVEY.md §5)."""
    model = LRModel()
    sopt = SparseAdagrad(0.1)
    dopt = optax.sgd(0.05)
    ds = tiny_dataset
    ids, y, w = ds.ids[:128], ds.labels[:128], np.ones(128, np.float32)

    tables = []
    for _ in range(2):
        sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=9)
        step = make_sharded_train_step(model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0)
        for _ in range(3):
            ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
            sst, _ = step(sst, ids_d, y_d, w_d)
        tables.append(np.asarray(sst.table))
    np.testing.assert_array_equal(tables[0], tables[1])


def test_overflow_policy_counts_drops(mesh, tiny_schema):
    """With capacity_factor << 1 and maximally skewed ids, overflow must be
    counted (not crash, not corrupt shapes)."""
    model = LRModel()
    sopt = SparseSgd(0.1)
    dopt = optax.sgd(0.05)
    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=0)
    step = make_sharded_train_step(
        model, tiny_schema, sopt, dopt, mesh, capacity_factor=0.05
    )
    B = 64
    # every id identical -> all occurrences hash to one shard -> overflow
    ids = np.zeros((B, tiny_schema.num_slots), np.int32)
    y = np.ones(B, np.float32)
    w = np.ones(B, np.float32)
    ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
    sst, (loss, dropped) = step(sst, ids_d, y_d, w_d)
    assert int(dropped) > 0
    assert np.isfinite(float(loss))


def test_sharded_scan_step_matches_loop(mesh, tiny_schema, tiny_dataset):
    from deepctr_tpu.parallel import make_sharded_scan_train_step

    model = FMModel(k=3)
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    ds = tiny_dataset
    T, B = 3, 64
    ids = ds.ids[: T * B].reshape(T, B, -1)
    y = ds.labels[: T * B].reshape(T, B)
    w = np.ones((T, B), np.float32)

    st1 = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=6)
    loop = make_sharded_train_step(model, tiny_schema, sopt, dopt, mesh,
                                   capacity_factor=8.0)
    losses1 = []
    for t in range(T):
        a, b_, c = shard_batch_arrays(mesh, ids[t], y[t], w[t])
        st1, (loss, _) = loop(st1, a, b_, c)
        losses1.append(float(loss))

    st2 = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=6)
    scan = make_sharded_scan_train_step(model, tiny_schema, sopt, dopt, mesh,
                                        capacity_factor=8.0)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax as _jax

    shd = NamedSharding(mesh, P(None, "data"))
    ids_d = _jax.device_put(ids, shd)
    y_d = _jax.device_put(y, shd)
    w_d = _jax.device_put(w, shd)
    st2, (losses2, dropped) = scan(st2, ids_d, y_d, w_d)
    np.testing.assert_allclose(losses1, np.asarray(losses2), rtol=1e-4, atol=1e-6)
    assert int(np.asarray(dropped).sum()) == 0
    np.testing.assert_allclose(
        np.asarray(st1.table), np.asarray(st2.table), rtol=1e-4, atol=1e-6
    )


# ---------------------------------------------------------------------------
# Split-embedding sharded path (small fields replicated via all_gather,
# big fields via all-to-all; ops/split_embed.py + sharded.py split support)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_sharded_split_matches_single_device(
    opt_name, mesh, tiny_schema, tiny_dataset
):
    from deepctr_tpu.ops.split_embed import make_split_plan

    model = FMModel(k=3)
    sopt = SparseSgd(0.1) if opt_name == "sgd" else SparseAdagrad(0.1)
    dopt = optax.sgd(0.05)
    # tiny_schema fields: a=4, b=8, c=16, tags=10x3 -> threshold 8 keeps
    # c(16) and tags(10)... pick 9 so c is big, a/b/tags small
    plan = make_split_plan(tiny_schema, threshold=9)
    assert plan.has_small and plan.big_slots

    B, steps = 64, 4
    ds = tiny_dataset
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(steps)
    ]

    st = init_state(model, tiny_schema, sopt, dopt, seed=3)
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False,
                            split=plan)
    losses1 = []
    for ids, y, w in batches:
        st, m = step1(st, ids, y, w)
        losses1.append(float(m.loss))

    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=3)
    stepN = make_sharded_train_step(
        model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0, split=plan
    )
    lossesN = []
    for ids, y, w in batches:
        ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
        sst, (loss, dropped) = stepN(sst, ids_d, y_d, w_d)
        lossesN.append(float(loss))
        assert int(dropped) == 0

    np.testing.assert_allclose(losses1, lossesN, rtol=1e-4, atol=1e-5)
    tableN = np.asarray(
        unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_allclose(np.asarray(st.table), tableN, rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(st.dense),
        jax.tree_util.tree_leaves(sst.dense),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_sharded_split_eval_matches_dense(mesh, tiny_schema, tiny_dataset):
    from deepctr_tpu.ops.split_embed import make_split_plan

    model = FMModel(k=3)
    plan = make_split_plan(tiny_schema, threshold=9)
    params = model.init_params(jax.random.PRNGKey(0), tiny_schema)
    ids = tiny_dataset.ids[:64]
    from deepctr_tpu.models import apply_model

    want = apply_model(model, params, jnp.asarray(ids), tiny_schema.pad_id)
    stored = pack_table(params["table"], 8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    stored = jax.device_put(stored, NamedSharding(mesh, P("data")))
    (ids_d,) = shard_batch_arrays(mesh, ids)
    eval_step = make_sharded_eval_step(
        model, tiny_schema, mesh, capacity_factor=8.0, split=plan
    )
    got = eval_step(stored, params["dense"], ids_d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_sharded_split_all_small(mesh, tiny_schema, tiny_dataset):
    """Every field below threshold: no exchange traffic carries real ids."""
    from deepctr_tpu.ops.split_embed import make_split_plan

    model = LRModel()
    plan = make_split_plan(tiny_schema, threshold=1000)
    assert plan.has_small and not plan.big_slots
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)

    st = init_state(model, tiny_schema, sopt, dopt, seed=5)
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False,
                            split=plan)
    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=5)
    stepN = make_sharded_train_step(
        model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0, split=plan
    )
    ids, y, w = (tiny_dataset.ids[:64], tiny_dataset.labels[:64],
                 np.ones(64, np.float32))
    st, m1 = step1(st, ids, y, w)
    ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
    sst, (loss, dropped) = stepN(sst, ids_d, y_d, w_d)
    assert int(dropped) == 0
    np.testing.assert_allclose(float(m1.loss), float(loss), rtol=1e-4)
    tableN = np.asarray(
        unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_allclose(np.asarray(st.table), tableN, rtol=1e-4,
                               atol=1e-5)


def test_sharded_bf16_exchange_close_to_f32(mesh, tiny_schema, tiny_dataset):
    """train.exchange_dtype=bf16 compresses only the WIRE payload of the
    row/grad all_to_all (the 2-host DCN knob, SCALING.md): the trajectory
    must track the f32-exchange trajectory within bf16 rounding, and the
    duplicate-id accumulation must still happen in f32 (exactness of the
    dedup path is what would break if the cast moved past the optimizer)."""
    model = FMModel(k=3)
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    ds = tiny_dataset
    B, steps = 64, 4
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(steps)
    ]

    tables = {}
    for dtype in ("f32", "bf16"):
        sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=3)
        step = make_sharded_train_step(
            model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0,
            exchange_dtype=dtype,
        )
        losses = []
        for ids, y, w in batches:
            ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
            sst, (loss, dropped) = step(sst, ids_d, y_d, w_d)
            assert int(dropped) == 0
            losses.append(float(loss))
        tables[dtype] = np.asarray(
            unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
        )
        assert np.all(np.isfinite(losses))
    # bf16 wire rounding is ~2^-8 relative per element; Adagrad's first-step
    # sign normalisation amplifies that on near-zero-gradient rows (measured
    # max |delta| ~0.011 over 4 steps), so atol covers ~2 such flips —
    # a systematic bug (double cast, lost gradient) would hit most elements
    np.testing.assert_allclose(tables["bf16"], tables["f32"], rtol=0.05,
                               atol=0.025)
    assert not np.array_equal(tables["bf16"], tables["f32"])


# ---------------------------------------------------------------------------
# The headline configuration's tower under sharding: the jnp tower with
# jax.random dropout plus the split plan
# ---------------------------------------------------------------------------


def test_sharded_pallas_tower_matches_single_device(
    mesh, tiny_schema, tiny_dataset
):
    """The jnp tower + split plan sharded trajectory must equal the
    single-device trajectory.  (The name is kept from when this tower was a
    Pallas kernel.)"""
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan

    model = make_fnn(tiny_schema, k=3,
                     mlp=MlpSpec(hidden=(32, 16), dropout=0.0))
    plan = make_split_plan(tiny_schema, threshold=9)
    assert plan.has_small and plan.big_slots
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    B, steps = 64, 3
    ds = tiny_dataset
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(steps)
    ]

    st = init_state(model, tiny_schema, sopt, dopt, seed=3)
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False,
                            split=plan)
    losses1 = []
    for ids, y, w in batches:
        st, m = step1(st, ids, y, w)
        losses1.append(float(m.loss))

    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=3)
    stepN = make_sharded_train_step(
        model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0, split=plan
    )
    lossesN = []
    for ids, y, w in batches:
        ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
        sst, (loss, dropped) = stepN(sst, ids_d, y_d, w_d)
        lossesN.append(float(loss))
        assert int(dropped) == 0

    np.testing.assert_allclose(losses1, lossesN, rtol=1e-4, atol=1e-5)
    tableN = np.asarray(
        unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_allclose(np.asarray(st.table), tableN, rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(st.dense),
        jax.tree_util.tree_leaves(sst.dense),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_sharded_pallas_dropout_deterministic_and_finite(
    mesh, tiny_schema, tiny_dataset
):
    """dropout > 0 through the jnp tower's jax.random masks under sharding:
    finite loss, and a bitwise-identical repeat from the same state (the
    per-shard rng is fold_in(step_rng, axis_index) — counter-based, so two
    runs of the same step must agree exactly).  (The name is kept from when
    this tower was a Pallas kernel.)"""
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan

    model = make_fnn(tiny_schema, k=3,
                     mlp=MlpSpec(hidden=(32, 16), dropout=0.5))
    plan = make_split_plan(tiny_schema, threshold=9)
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    ds = tiny_dataset
    ids, y, w = ds.ids[:64], ds.labels[:64], np.ones(64, np.float32)

    tables, losses = [], []
    for _ in range(2):
        sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=7)
        step = make_sharded_train_step(
            model, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0,
            split=plan,
        )
        for _ in range(2):
            ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
            sst, (loss, dropped) = step(sst, ids_d, y_d, w_d)
            assert np.isfinite(float(loss))
            assert int(dropped) == 0
        tables.append(np.asarray(sst.table))
        losses.append(float(loss))
    np.testing.assert_array_equal(tables[0], tables[1])
    assert losses[0] == losses[1]
    # dropout actually engaged: the trajectory differs from the no-dropout one
    model0 = make_fnn(tiny_schema, k=3,
                      mlp=MlpSpec(hidden=(32, 16), dropout=0.0))
    sst0 = init_sharded_state(model0, tiny_schema, sopt, dopt, mesh, seed=7)
    step0 = make_sharded_train_step(
        model0, tiny_schema, sopt, dopt, mesh, capacity_factor=8.0, split=plan
    )
    for _ in range(2):
        ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
        sst0, _ = step0(sst0, ids_d, y_d, w_d)
    assert not np.array_equal(tables[0], np.asarray(sst0.table))


# ---------------------------------------------------------------------------
# Prepared-state handoff (pretraining / FM init / resume -> sharded layout)
# ---------------------------------------------------------------------------


def test_sharded_state_from_state_roundtrip(mesh, tiny_schema):
    """Packing a prepared TrainState onto the mesh and unpacking it back must
    preserve the table, the table-shaped Adagrad accumulator, dense params,
    the step counter and the RNG — the contract the CLI's pretrain/FM-init/
    resume handoff relies on."""
    from deepctr_tpu.parallel import host_state_from_sharded, sharded_state_from_state

    model = FMModel(k=3)
    sopt, dopt = SparseAdagrad(0.1), optax.adagrad(0.05)
    st = init_state(model, tiny_schema, sopt, dopt, seed=11)
    # make the state distinctive (as pretraining would)
    st = st._replace(
        table=st.table + 7.0,
        sparse_state=st.sparse_state._replace(acc=st.sparse_state.acc + 3.0),
        step=jnp.asarray(42, jnp.int32),
    )
    sst = sharded_state_from_state(st, mesh)
    got = np.asarray(
        unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_array_equal(got, np.asarray(st.table))
    acc = np.asarray(
        unpack_table(sst.sparse_state.acc, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_array_equal(acc, np.asarray(st.sparse_state.acc))
    assert int(sst.step) == 42

    back = host_state_from_sharded(sst, tiny_schema.padded_vocab_size, mesh)
    np.testing.assert_array_equal(back.table, np.asarray(st.table))
    np.testing.assert_array_equal(back.sparse_state.acc,
                                  np.asarray(st.sparse_state.acc))
    for a, b in zip(jax.tree_util.tree_leaves(st.dense),
                    jax.tree_util.tree_leaves(back.dense)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(st.rng), back.rng)


def test_sharded_lr_scale_matches_single_device(mesh, tiny_schema, tiny_dataset):
    """lr_scale (epoch LR decay) must decay sharded training identically to
    the single-device step (VERDICT weak #8)."""
    model = FMModel(k=3)
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    ds = tiny_dataset
    B = 64
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(3)
    ]
    scales = [1.0, 0.5, 0.25]

    st = init_state(model, tiny_schema, sopt, dopt, seed=3)
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False)
    for (ids, y, w), s in zip(batches, scales):
        st, _ = step1(st, ids, y, w, s)

    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=3)
    stepN = make_sharded_train_step(model, tiny_schema, sopt, dopt, mesh,
                                    capacity_factor=8.0)
    for (ids, y, w), s in zip(batches, scales):
        ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
        sst, _ = stepN(sst, ids_d, y_d, w_d, s)

    tableN = np.asarray(
        unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    )
    np.testing.assert_allclose(np.asarray(st.table), tableN, rtol=1e-4,
                               atol=1e-5)


def test_sharded_bf16_table_matches_single_device(mesh, tiny_schema,
                                                  tiny_dataset):
    """table_dtype='bf16' under sharding (the round-3 headline storage knob):
    the sharded bf16-stored trajectory must equal the single-device
    bf16-stored trajectory — same rounding points (f32 math, bf16 row
    storage), split plan on so both the exchange and the all_gathered
    small-subtable paths are exercised."""
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan

    model = make_fnn(tiny_schema, k=3,
                     mlp=MlpSpec(hidden=(16,), dropout=0.0))
    plan = make_split_plan(tiny_schema, threshold=9)
    assert plan.has_small and plan.big_slots
    sopt, dopt = SparseAdagrad(0.1, scratch_dtype="bf16"), optax.sgd(0.05)
    B, steps = 64, 4
    ds = tiny_dataset
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(steps)
    ]

    st = init_state(model, tiny_schema, sopt, dopt, seed=3,
                    table_dtype="bf16")
    assert st.table.dtype == jnp.bfloat16
    step1 = make_train_step(model, tiny_schema, sopt, dopt, jit=False,
                            split=plan)
    losses1 = []
    for ids, y, w in batches:
        st, m = step1(st, ids, y, w)
        losses1.append(float(m.loss))

    sst = init_sharded_state(model, tiny_schema, sopt, dopt, mesh, seed=3,
                             table_dtype="bf16")
    assert sst.table.dtype == jnp.bfloat16
    # accumulator stays f32 (bf16 increments would stagnate)
    assert jax.tree_util.tree_leaves(sst.sparse_state)[0].dtype == jnp.float32
    stepN = make_sharded_train_step(model, tiny_schema, sopt, dopt, mesh,
                                    capacity_factor=8.0, split=plan)
    lossesN = []
    for ids, y, w in batches:
        ids_d, y_d, w_d = shard_batch_arrays(mesh, ids, y, w)
        sst, (loss, dropped) = stepN(sst, ids_d, y_d, w_d)
        lossesN.append(float(loss))
        assert int(dropped) == 0

    np.testing.assert_allclose(losses1, lossesN, rtol=1e-3, atol=1e-4)
    tableN = unpack_table(sst.table, tiny_schema.padded_vocab_size, 8)
    assert tableN.dtype == jnp.bfloat16
    # bf16 storage rounds at the same points on both paths -> near-equal
    np.testing.assert_allclose(
        np.asarray(st.table, np.float32), np.asarray(tableN, np.float32),
        rtol=1e-2, atol=1e-3,
    )

    # sharded eval consumes the bf16 shards directly
    ev = make_sharded_eval_step(model, tiny_schema, mesh, capacity_factor=8.0,
                                split=plan)
    (ids_d,) = shard_batch_arrays(mesh, ds.ids[:64])
    logits = ev(sst.table, sst.dense, ids_d)
    assert np.isfinite(np.asarray(logits)).all()


def test_host_shard_checkpoint_roundtrip_and_resume(tiny_schema, tiny_dataset,
                                                    tmp_path):
    """Per-host sharded checkpoint (parallel/hostckpt.py): every leaf
    survives save/load bitwise, and training continued from the reloaded
    state matches the uninterrupted trajectory exactly (the multi-host
    restart-from-checkpoint mechanism; the 2-process kill+restore drill is
    tools/multihost_sim.py phase 3)."""
    import optax

    from deepctr_tpu.models import FMModel
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.parallel import (
        init_sharded_state,
        load_host_shards,
        make_data_mesh,
        make_sharded_train_step,
        save_host_shards,
        shard_batch_arrays,
    )

    ds = tiny_dataset
    schema = tiny_schema
    mesh = make_data_mesh(8)
    model = FMModel(k=3)
    sopt, dopt = SparseAdagrad(0.1), optax.sgd(0.05)
    step = make_sharded_train_step(model, schema, sopt, dopt, mesh,
                                   capacity_factor=8.0)
    B = 64
    batches = [
        (ds.ids[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B],
         np.ones(B, np.float32))
        for i in range(4)
    ]

    def run_steps(state, batch_list):
        losses = []
        for ids, y, w in batch_list:
            state, (loss, dropped) = step(
                state, *shard_batch_arrays(mesh, ids, y, w))
            losses.append(float(loss))
        return state, losses

    st0 = init_sharded_state(model, schema, sopt, dopt, mesh, seed=3)
    st2, losses01 = run_steps(st0, batches[:2])
    save_host_shards(str(tmp_path / "ck"), st2, epoch=1)
    # snapshot before the continuation donates st2's buffers
    st2_np = [np.asarray(x) for x in jax.tree_util.tree_leaves(st2)]
    st_full, losses23 = run_steps(st2, batches[2:])

    like = init_sharded_state(model, schema, sopt, dopt, mesh, seed=99)
    st_re, epoch = load_host_shards(str(tmp_path / "ck"), like)
    assert epoch == 1
    # bitwise leaf equality after the roundtrip
    for a, b in zip(st2_np, jax.tree_util.tree_leaves(st_re)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # resumed trajectory == uninterrupted trajectory
    st_resumed, losses23_re = run_steps(st_re, batches[2:])
    np.testing.assert_allclose(losses23_re, losses23, rtol=0, atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(st_full),
                    jax.tree_util.tree_leaves(st_resumed)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
