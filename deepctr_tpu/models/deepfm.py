"""DeepFM — FM + deep tower over shared embeddings.

BASELINE.json:11 names the stretch config "DeepFM-style FNN on Criteo
1TB-scale hash space".  DeepFM (Guo et al., IJCAI'17 — the successor design
to the reference's FNN) sums an FM scorer and a DNN tower that SHARE one
embedding table, removing FNN's two-phase pretraining requirement:

    ŷ = σ( FM(w, v; x) + MLP(concat per-field (w_i, v_i)) )

Table layout matches FM/FNN ([V+1, 1+k] = (w | v)), so checkpoints
interoperate: a trained FM table can seed DeepFM and vice versa.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..data.schema import Schema
from ..ops.interaction import fm_interaction
from .base import MlpSpec, Params, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class DeepFMModel:
    """Construct via :func:`make_deepfm` to bind the slot->field map."""

    slot_field: tuple[int, ...]
    num_fields: int
    k: int = 10
    mlp: MlpSpec = MlpSpec(hidden=(200, 200), activation="relu", dropout=0.5)
    init_sigma: float = 0.01
    name: str = "deepfm"

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        return (schema.padded_vocab_size, 1 + self.k)

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        V, D = self.table_shape(schema)
        r_tab, r_mlp = jax.random.split(rng)
        table = self.init_sigma * jax.random.normal(r_tab, (V, D), jnp.float32)
        table = table.at[:, 0].set(0.0)
        table = table.at[schema.pad_id].set(0.0)
        in_dim = self.num_fields * D
        return {
            "table": table,
            "dense": {
                "mlp": init_mlp(r_mlp, in_dim, self.mlp),
                "bias": jnp.zeros((), jnp.float32),
            },
        }

    def apply_rows(self, dense, rows, mask, *, train=False, rng=None):
        # --- FM side (shared rows)
        w = rows[..., 0]
        v = rows[..., 1:]
        fm_part = (w * mask).sum(axis=1) + fm_interaction(v, mask)
        # --- deep side (same rows, per-field pooled concat)
        x = rows * mask[..., None]
        slot_field = jnp.asarray(self.slot_field, jnp.int32)
        onehot = jax.nn.one_hot(slot_field, self.num_fields, dtype=x.dtype)
        pooled = jnp.einsum("bsd,sf->bfd", x, onehot)
        flat = pooled.reshape(pooled.shape[0], -1)
        deep_part = apply_mlp(dense["mlp"], flat, self.mlp, train=train, rng=rng)
        return fm_part + deep_part + dense["bias"]


def make_deepfm(
    schema: Schema,
    k: int = 10,
    mlp: MlpSpec | None = None,
    init_sigma: float = 0.01,
) -> DeepFMModel:
    return DeepFMModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        k=k,
        mlp=mlp or MlpSpec(hidden=(200, 200), activation="relu", dropout=0.5),
        init_sigma=init_sigma,
    )
