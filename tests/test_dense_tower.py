"""The plain-jnp dense tower and FM scorer that every model runs on the
device, checked against the NumPy reference (reference_impl/numpy_ref.py)
and brute force."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deepctr_tpu.data import ipinyou_like_schema, synthetic
from deepctr_tpu.models import FMModel, MlpSpec, make_fnn
from deepctr_tpu.models.base import (
    apply_mlp,
    apply_model,
    init_mlp,
    weighted_bce_with_logits,
)
from deepctr_tpu.ops import fm_interaction_bruteforce
from deepctr_tpu.reference_impl import NumpyFM, NumpyFNN

HIDDEN = (200, 300, 100)


@pytest.fixture(scope="module")
def full_width():
    """The flagship tower widths: 16 fields x (1+k=11) = 176 -> 200 -> 300
    -> 100 -> 1, with the NumPy reference's init."""
    schema = ipinyou_like_schema()
    ds = synthetic.generate(schema, num_examples=512, k=4, seed=3)
    ref = NumpyFNN(schema, k=10, hidden=HIDDEN, lr=1.0, seed=12)
    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=HIDDEN, dropout=0.0))
    params = {
        "table": jnp.asarray(ref.table.copy()),
        "dense": {"mlp": {"layers": [
            {"w": jnp.asarray(w.copy()), "b": jnp.asarray(b.copy())}
            for w, b in ref.layers]}},
    }
    assert ref.layers[0][0].shape == (176, 200)
    return schema, ds, ref, model, params


def test_tower_forward_matches_numpy_at_full_width(full_width):
    schema, ds, ref, model, params = full_width
    with jax.default_matmul_precision("highest"):
        got = apply_model(model, params, jnp.asarray(ds.ids), schema.pad_id)
    np.testing.assert_allclose(np.asarray(got), ref.forward(ds.ids),
                               rtol=1e-4, atol=1e-6)


def test_tower_gradients_match_numpy_at_full_width(full_width):
    """One reference SGD step at lr=1 is exactly minus the gradient."""
    schema, ds, ref, model, params = full_width
    ids, y = ds.ids, ds.labels
    before = [(w.copy(), b.copy()) for w, b in ref.layers]
    ref.train_batch(ids, y)
    try:
        def loss(dense):
            logits = apply_model(model, {"table": params["table"],
                                         "dense": dense},
                                 jnp.asarray(ids), schema.pad_id)
            return weighted_bce_with_logits(logits, jnp.asarray(y),
                                            jnp.ones(len(y)))

        with jax.default_matmul_precision("highest"):
            g = jax.grad(loss)(params["dense"])
        for (w0, b0), (w1, b1), layer in zip(before, ref.layers,
                                             g["mlp"]["layers"]):
            np.testing.assert_allclose(np.asarray(layer["w"]), w0 - w1,
                                       rtol=1e-3, atol=1e-7)
            np.testing.assert_allclose(np.asarray(layer["b"]), b0 - b1,
                                       rtol=1e-3, atol=1e-7)
    finally:
        ref.layers = [[w.copy(), b.copy()] for w, b in before]


def _tower(in_dim=48, seed=7):
    spec = MlpSpec(hidden=(64, 32), activation="tanh", dropout=0.5)
    mlp = init_mlp(jax.random.PRNGKey(seed), in_dim, spec)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (128, in_dim))
    return spec, mlp, x


def test_dropout_is_deterministic_per_rng():
    spec, mlp, x = _tower()
    a = apply_mlp(mlp, x, spec, train=True, rng=jax.random.PRNGKey(3))
    b = apply_mlp(mlp, x, spec, train=True, rng=jax.random.PRNGKey(3))
    c = apply_mlp(mlp, x, spec, train=True, rng=jax.random.PRNGKey(4))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.abs(np.asarray(a) - np.asarray(c)).max() > 1e-6
    # eval mode ignores the rng and drops nothing
    e = apply_mlp(mlp, x, spec, train=False)
    np.testing.assert_array_equal(
        np.asarray(e), np.asarray(apply_mlp(mlp, x, spec, train=False)))


def test_dropout_keep_rate():
    """A rigged tower exposes the first layer's mask: W1 = 0 and
    b1 = atanh(0.5) make every hidden unit 0.5, and W2 = ones sums the kept
    units, so mean_logit = (0.5 / keep) * h1 * keep_hat.  128 x 64 draws x 8
    seeds pin keep_hat to about +-1% at 3 sigma."""
    h1, keep = 64, 0.5
    spec = MlpSpec(hidden=(h1,), activation="tanh", dropout=1 - keep)
    rig = {"layers": [
        {"w": jnp.zeros((48, h1)), "b": jnp.full((h1,), np.arctanh(0.5))},
        {"w": jnp.ones((h1, 1)), "b": jnp.zeros((1,))},
    ]}
    x = jnp.ones((128, 48))
    means = [
        float(apply_mlp(rig, x, spec, train=True,
                        rng=jax.random.PRNGKey(100 + s)).mean())
        for s in range(8)
    ]
    keep_hat = np.mean(means) * keep / (0.5 * h1)
    assert abs(keep_hat - keep) < 0.015, keep_hat


@pytest.mark.parametrize("batch", [1, 100, 257])
def test_fm_matches_bruteforce_at_odd_batch_sizes(batch):
    rng = np.random.default_rng(batch)
    rows = jnp.asarray(rng.normal(size=(batch, 7, 6)).astype(np.float32))
    mask = jnp.asarray((rng.random((batch, 7)) < 0.8).astype(np.float32))
    model = FMModel(k=5)
    got = model.apply_rows({"bias": jnp.float32(0.25)}, rows, mask)
    want = ((rows[..., 0] * mask).sum(axis=1)
            + fm_interaction_bruteforce(rows[..., 1:], mask) + 0.25)
    assert got.shape == (batch,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_fm_table_gradient_matches_numpy(tiny_schema, tiny_dataset):
    """One NumpyFM SGD step at lr=1 is exactly minus the table gradient."""
    ref = NumpyFM(tiny_schema, k=3, lr=1.0, seed=11)
    table0 = ref.table.copy()
    ids, y = tiny_dataset.ids[:256], tiny_dataset.labels[:256]
    ref.train_batch(ids, y)
    model = FMModel(k=3)

    def loss(table):
        logits = apply_model(model, {"table": table,
                                     "dense": {"bias": jnp.float32(0.0)}},
                             jnp.asarray(ids), tiny_schema.pad_id)
        return weighted_bce_with_logits(logits, jnp.asarray(y),
                                        jnp.ones(len(y)))

    g = jax.grad(loss)(jnp.asarray(table0))
    np.testing.assert_allclose(np.asarray(g), table0 - ref.table,
                               rtol=1e-4, atol=1e-7)
    # and the same gradient drives the production step to the same table
    from deepctr_tpu.optim import SparseSgd
    from deepctr_tpu.train import init_state, make_train_step

    st = init_state(model, tiny_schema, SparseSgd(1.0), optax.sgd(1.0))
    st = st._replace(table=jnp.asarray(table0))
    step = make_train_step(model, tiny_schema, SparseSgd(1.0), optax.sgd(1.0),
                           jit=False)
    st, _ = step(st, ids, y, np.ones(len(y), np.float32))
    np.testing.assert_allclose(np.asarray(st.table), ref.table,
                               rtol=1e-4, atol=1e-7)
