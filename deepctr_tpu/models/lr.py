"""LR — sparse logistic regression.

Reference parity: component C4 (SURVEY.md §2.1, §2.3):
``ŷ = σ( Σ_{i∈active} w_i + b )``, SGD/Adagrad with L2, trained on the
one-hot yx data.  Device form: the weight vector is a ``[V+1, 1]``
"table" so the shared gather + sparse-update path applies unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..data.schema import Schema
from .base import Params


@dataclasses.dataclass(frozen=True)
class LRModel:
    name: str = "lr"
    init_scale: float = 0.0  # reference initialises linear weights near zero

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        return (schema.padded_vocab_size, 1)

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        shape = self.table_shape(schema)
        if self.init_scale > 0.0:
            table = self.init_scale * jax.random.normal(rng, shape, jnp.float32)
            table = table.at[schema.pad_id].set(0.0)
        else:
            table = jnp.zeros(shape, jnp.float32)
        return {"table": table, "dense": {"bias": jnp.zeros((), jnp.float32)}}

    def apply_rows(self, dense, rows, mask, *, train=False, rng=None):
        del train, rng
        # rows: [B, S, 1]; mask: [B, S]
        return (rows[..., 0] * mask).sum(axis=1) + dense["bias"]
