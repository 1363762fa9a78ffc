"""Training-loop behaviours: LR decay, early stopping, lr_scale plumbing."""

import jax.numpy as jnp
import numpy as np
import optax

from deepctr_tpu.models import FMModel, LRModel
from deepctr_tpu.optim import SparseAdagrad, SparseSgd
from deepctr_tpu.train import fit, init_state, make_train_step


def test_lr_scale_scales_update(tiny_schema, tiny_dataset):
    model = LRModel()
    sopt, dopt = SparseSgd(0.1), optax.sgd(0.1)
    step = make_train_step(model, tiny_schema, sopt, dopt, jit=False)
    ids = tiny_dataset.ids[:64]
    y = tiny_dataset.labels[:64]
    w = np.ones(64, np.float32)

    st = init_state(model, tiny_schema, sopt, dopt, seed=0)
    full, _ = step(st, ids, y, w, 1.0)
    st = init_state(model, tiny_schema, sopt, dopt, seed=0)
    half, _ = step(st, ids, y, w, 0.5)
    st = init_state(model, tiny_schema, sopt, dopt, seed=0)

    d_full = np.asarray(full.table) - np.asarray(st.table)
    d_half = np.asarray(half.table) - np.asarray(st.table)
    np.testing.assert_allclose(d_half, 0.5 * d_full, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        float(half.dense["bias"]), 0.5 * float(full.dense["bias"]), rtol=1e-5
    )


def test_fit_with_lr_decay_converges(tiny_schema, tiny_dataset):
    ds = tiny_dataset
    res = fit(
        FMModel(k=3),
        tiny_schema,
        ds.ids[:3000],
        ds.labels[:3000],
        ds.ids[3000:],
        ds.labels[3000:],
        sparse_opt=SparseAdagrad(0.1),
        dense_opt=optax.adagrad(0.05),
        batch_size=256,
        epochs=4,
        lr_decay=0.5,
        prefetch=False,
        early_stop_patience=4,
    )
    assert res.best_auc > 0.6


def test_early_stopping_stops(tiny_schema, tiny_dataset):
    ds = tiny_dataset
    res = fit(
        LRModel(),
        tiny_schema,
        ds.ids[:1000],
        ds.labels[:1000],
        ds.ids[1000:1500],
        ds.labels[1000:1500],
        sparse_opt=SparseSgd(0.0),  # no learning -> AUC exactly flat -> stop
        dense_opt=optax.sgd(0.0),
        batch_size=256,
        epochs=50,
        early_stop_patience=1,
        prefetch=False,
    )
    assert len(res.history) <= 4


def test_scan_chunked_fit_matches_per_step(tiny_schema, tiny_dataset):
    """fit(scan_steps=N) must produce the same trajectory as the per-step
    loop (same shuffles, same math) including the padded final chunk."""
    ds = tiny_dataset
    kw = dict(
        sparse_opt=SparseAdagrad(0.1),
        dense_opt=optax.sgd(0.05),
        batch_size=100,   # 3000/100 = 30 batches; scan_steps=7 -> pad path
        epochs=2,
        prefetch=False,
        early_stop_patience=5,
        seed=4,
    )
    res_a = fit(
        FMModel(k=3), tiny_schema,
        ds.ids[:3000], ds.labels[:3000], ds.ids[3000:], ds.labels[3000:], **kw
    )
    res_b = fit(
        FMModel(k=3), tiny_schema,
        ds.ids[:3000], ds.labels[:3000], ds.ids[3000:], ds.labels[3000:],
        scan_steps=7, **kw
    )
    np.testing.assert_allclose(
        np.asarray(res_a.state.table), np.asarray(res_b.state.table),
        rtol=1e-4, atol=1e-6,
    )
    for ha, hb in zip(res_a.history, res_b.history):
        np.testing.assert_allclose(ha["auc"], hb["auc"], rtol=1e-6)
        np.testing.assert_allclose(ha["train_loss"], hb["train_loss"], rtol=1e-4)


def test_bf16_table_trains_and_checkpoints(tiny_schema, tiny_dataset, tmp_path):
    """table_dtype='bf16' (the device-memory bandwidth knob): training reaches
    the same quality band as f32 (math stays f32 — only storage rounds), the
    Adagrad accumulator stays f32, and a bf16 checkpoint round-trips."""
    import optax

    from deepctr_tpu.models import FMModel
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import fit
    from deepctr_tpu.utils.checkpoint import load_train_state, save_train_state

    ds = tiny_dataset
    n = ds.ids.shape[0]
    tr, te = slice(0, int(0.8 * n)), slice(int(0.8 * n), n)

    res = {}
    # "bf16s" = the full round-3 production config (bench.py): bf16 table
    # storage AND bf16 gradient-scratch in the sparse Adagrad — BOTH knobs
    # must hold the f32 quality band (ADVICE r3: the scratch half previously
    # had no CI quality gate)
    for dt, scratch in (("f32", "f32"), ("bf16", "f32"), ("bf16s", "bf16")):
        r = fit(
            FMModel(k=3), tiny_schema, ds.ids[tr], ds.labels[tr],
            ds.ids[te], ds.labels[te],
            sparse_opt=SparseAdagrad(0.1, scratch_dtype=scratch),
            dense_opt=optax.adagrad(0.05),
            batch_size=128, epochs=3, seed=0, prefetch=False,
            early_stop_patience=99,
            table_dtype="bf16" if dt.startswith("bf16") else "f32",
        )
        res[dt] = r
    assert str(res["bf16"].state.table.dtype) == "bfloat16"
    assert str(res["bf16"].state.sparse_state.acc.dtype) == "float32"
    assert abs(res["bf16"].best_auc - res["f32"].best_auc) < 0.01
    assert abs(res["bf16s"].best_auc - res["f32"].best_auc) < 0.01

    path = str(tmp_path / "bf16.ckpt")
    save_train_state(path, res["bf16"].state, epoch=3, schema=tiny_schema)
    back = load_train_state(path, res["bf16"].state)
    assert str(back.table.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(back.table, dtype=np.float32),
        np.asarray(res["bf16"].state.table, dtype=np.float32),
    )
