"""Checkpoint/resume + the FM->FNN init handoff.

Reference parity: SURVEY.md §5 checkpoint row — the reference's one real
persistence path is FM persisting (w, v) arrays for FNN to consume
(SURVEY.md §3.2).  Here that becomes a first-class "init-from-checkpoint"
feature, plus full train-state checkpointing for resume.

Format: flat ``np.savez`` of the flattened pytree leaves + a JSON treedef
manifest — dependency-light, and table shards can be saved per-host when
row-sharded (each host saves only rows it owns; see parallel/).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np


def _flatten(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, str(treedef)


def save_pytree(path: str, tree, extra: dict | None = None) -> None:
    """Atomic npz save of a pytree; ``extra`` merges into the JSON manifest
    (used for checkpoint metadata: epochs completed, optimizer kind, ...).

    bfloat16 leaves (table_dtype="bf16" training) are stored as uint16 views
    with a manifest marker — np.savez has no bfloat16 representation."""
    leaves, treedef = _flatten(tree)
    arrays, bf16 = {}, []
    for i, x in enumerate(leaves):
        a = np.asarray(x)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.view(np.uint16)
            bf16.append(i)
        arrays[f"leaf_{i}"] = a
    manifest = {"n": len(leaves), "treedef": treedef, "bf16_leaves": bf16}
    if extra:
        manifest.update(extra)
    tmp = path + ".tmp"
    np.savez(tmp, manifest=json.dumps(manifest), **arrays)
    src = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(src, path)


def load_pytree(path: str, like):
    """Load leaves saved by save_pytree into the structure of ``like``."""
    import jax.numpy as jnp
    import ml_dtypes

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        bf16 = set(manifest.get("bf16_leaves", ()))
        leaves = []
        for i in range(manifest["n"]):
            a = z[f"leaf_{i}"]
            if i in bf16:
                a = a.view(ml_dtypes.bfloat16)
            leaves.append(jnp.asarray(a))
    _, treedef = jax.tree_util.tree_flatten(like)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def read_manifest(path: str) -> dict:
    """Read the JSON manifest of a checkpoint without loading the arrays."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["manifest"]))


def save_train_state(path: str, state, epoch: int = 0,
                     meta: dict | None = None, schema=None) -> None:
    """Save a TrainState checkpoint.  ``epoch`` records epochs COMPLETED so
    resume continues the epoch schedule (shuffle seeds, LR decay) exactly
    where the killed run stopped.

    The manifest additionally records where the ``table`` and ``dense``
    leaves sit in the flat leaf list ("scoring" entry), so serving can load
    model params without reconstructing the optimizer-state pytree.

    ``schema``: when given, its JSON rides in the manifest so scoring never
    reconstructs the id space from config — a featindex- or criteo-trained
    checkpoint scores under the exact schema it trained with (the reference's
    pred_fn shares the train script's in-memory index map, SURVEY.md §3.1;
    a standalone scorer must persist it).
    """
    extra = {"epoch": int(epoch)}
    if meta:
        extra.update(meta)
    if schema is not None:
        extra["schema_json"] = schema.to_json()
    # TrainState field order: step, table, sparse_state, dense, dense_state,
    # rng -> table is leaf 1; dense leaves follow the sparse-state leaves
    n_sparse = len(jax.tree_util.tree_leaves(state.sparse_state))
    n_dense = len(jax.tree_util.tree_leaves(state.dense))
    extra["scoring"] = {
        "table_leaf": 1,
        "dense_start": 2 + n_sparse,
        "n_dense": n_dense,
    }
    save_pytree(path, state, extra=extra)


def load_train_state(path: str, like):
    return load_pytree(path, like)


def load_scoring_params(path: str, dense_like):
    """Load just (table, dense) from a train-state checkpoint — the serving
    path (no optimizer state is materialised).  ``dense_like`` provides the
    dense-params pytree structure (from ``model.init_params``)."""
    import jax.numpy as jnp

    manifest = read_manifest(path)
    sc = manifest["scoring"]
    _, dense_def = jax.tree_util.tree_flatten(dense_like)
    if dense_def.num_leaves != sc["n_dense"]:
        raise ValueError(
            f"checkpoint {path} has {sc['n_dense']} dense leaves, model "
            f"expects {dense_def.num_leaves} — model/config mismatch"
        )
    import ml_dtypes

    bf16 = set(manifest.get("bf16_leaves", ()))

    def leaf(z, i):
        a = z[f"leaf_{i}"]
        if i in bf16:
            a = a.view(ml_dtypes.bfloat16)
        return jnp.asarray(a)

    with np.load(path, allow_pickle=False) as z:
        table = leaf(z, sc["table_leaf"])
        dense_leaves = [
            leaf(z, sc["dense_start"] + i) for i in range(sc["n_dense"])
        ]
    return table, jax.tree_util.tree_unflatten(dense_def, dense_leaves)


# ---------------------------------------------------------------------------
# FM -> FNN handoff (SURVEY.md C5/C6: FNN bottom layer z_f = (w_i, v_i))
# ---------------------------------------------------------------------------


def save_fm_embeddings(path: str, fm_table: jax.Array) -> None:
    """Persist a trained FM's [V+1, 1+k] (w|v) table."""
    save_pytree(path, {"fm_table": fm_table})


def load_fm_embeddings(path: str) -> np.ndarray:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        assert manifest["n"] == 1
        return z["leaf_0"]


def init_fnn_from_fm(fnn_params: dict, fm_table: np.ndarray | jax.Array) -> dict:
    """Replace FNN's embedding table with the trained FM (w|v) rows.

    Table layouts match by construction ([V+1, 1+k], FM row = (w_i, v_i)),
    so the handoff is a copy — the equivalent of the reference's
    pickle-and-reload (SURVEY.md §3.2, §3.1 "[pretrain input] load FM
    weights (w_i, v_i) trained by FM.py").
    """
    import jax.numpy as jnp

    fm_table = jnp.asarray(fm_table)
    if fm_table.shape != fnn_params["table"].shape:
        raise ValueError(
            f"FM table {fm_table.shape} does not match FNN table "
            f"{fnn_params['table'].shape}; train FM with the same schema and k"
        )
    return {**fnn_params, "table": fm_table}


def init_snn_from_pretrain(snn_params: dict, table, b1) -> dict:
    """Seed SNN's supervised phase from DAE/RBM pretraining output."""
    import jax.numpy as jnp

    table = jnp.asarray(table)
    if table.shape != snn_params["table"].shape:
        raise ValueError(
            f"pretrained table {table.shape} != SNN table {snn_params['table'].shape}"
        )
    dense = dict(snn_params["dense"])
    dense["b1"] = jnp.asarray(b1)
    return {**snn_params, "table": table, "dense": dense}
