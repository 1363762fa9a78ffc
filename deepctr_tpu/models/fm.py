"""FM — factorization machine, k latent factors.

Reference parity: component C5 (SURVEY.md §2.1, §2.3):
``ŷ = σ( w0 + Σ_i w_i + Σ_{i<j} <v_i, v_j> )`` with v_i ∈ R^k (k=10 in the
reference's headline config, BASELINE.json:8), the pairwise term computed
via the O(N·k) sum-of-squares identity.  Also the producer of pretrained
embeddings for FNN (SURVEY.md C5 "the producer of pretrained embeddings").

Table layout: row i = (w_i, v_i1..v_ik), i.e. ``[V+1, 1+k]`` — exactly the
(w, v) pair FNN's bottom layer consumes, so the FM->FNN handoff is a plain
table copy (deepctr_tpu/utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..data.schema import Schema
from ..ops.interaction import fm_interaction
from .base import Params


@dataclasses.dataclass(frozen=True)
class FMModel:
    k: int = 10
    init_sigma: float = 0.01
    name: str = "fm"

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        return (schema.padded_vocab_size, 1 + self.k)

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        V, D = self.table_shape(schema)
        table = self.init_sigma * jax.random.normal(rng, (V, D), jnp.float32)
        table = table.at[:, 0].set(0.0)          # linear weights start at zero
        table = table.at[schema.pad_id].set(0.0)  # frozen pad row
        return {"table": table, "dense": {"bias": jnp.zeros((), jnp.float32)}}

    def apply_rows(self, dense, rows, mask, *, train=False, rng=None):
        del train, rng
        # rows: [B, S, 1+k] = (w | v)
        w = rows[..., 0]            # [B, S]
        v = rows[..., 1:]           # [B, S, k]
        linear = (w * mask).sum(axis=1)
        inter = fm_interaction(v, mask)
        return linear + inter + dense["bias"]
