"""FNN — FM-initialised feed-forward network (the flagship model).

Reference parity: component C6 (SURVEY.md §2.1, §2.3, §3.1): bottom layer is
a per-field dense embedding ``z_f = (w_i, v_i1..v_ik)`` gathered from a
shared ``[V, 1+k]`` matrix, **initialised from a trained FM**; the per-field
vectors are concatenated and fed through tanh hidden layers (the paper's
best "diamond" shape uses 3 hidden layers, dropout regularisation) to a
sigmoid output, then the whole net is fine-tuned end-to-end.

Design notes: multi-slot fields (user tags) are sum-pooled to one
(1+k)-vector per field; the slot->field pooling is a static one-hot
contraction that XLA fuses into the first matmul.  The dense stack is plain
``jax.numpy`` (``apply_mlp``), compiled and fused by XLA.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..data.schema import Schema
from .base import MlpSpec, Params, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class FNNModel:
    """Construct via :func:`make_fnn` so the static slot->field map is bound."""

    slot_field: tuple[int, ...]   # static: owning field of each packed slot
    num_fields: int
    k: int = 10
    mlp: MlpSpec = MlpSpec(hidden=(200, 300, 100), activation="tanh", dropout=0.5)
    init_sigma: float = 0.01
    name: str = "fnn"

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        return (schema.padded_vocab_size, 1 + self.k)

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        V, D = self.table_shape(schema)
        r_tab, r_mlp = jax.random.split(rng)
        table = self.init_sigma * jax.random.normal(r_tab, (V, D), jnp.float32)
        table = table.at[schema.pad_id].set(0.0)
        in_dim = self.num_fields * D
        return {"table": table, "dense": {"mlp": init_mlp(r_mlp, in_dim, self.mlp)}}

    def apply_rows(self, dense, rows, mask, *, train=False, rng=None):
        # rows: [B, S, 1+k]
        x = rows * mask[..., None]
        slot_field = jnp.asarray(self.slot_field, jnp.int32)
        onehot = jax.nn.one_hot(slot_field, self.num_fields, dtype=x.dtype)
        pooled = jnp.einsum("bsd,sf->bfd", x, onehot)          # [B, F, 1+k]
        flat = pooled.reshape(pooled.shape[0], -1)             # [B, F*(1+k)]
        return apply_mlp(dense["mlp"], flat, self.mlp, train=train, rng=rng)


def make_fnn(
    schema: Schema,
    k: int = 10,
    mlp: MlpSpec | None = None,
    init_sigma: float = 0.01,
) -> FNNModel:
    return FNNModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        k=k,
        mlp=mlp or MlpSpec(hidden=(200, 300, 100), activation="tanh", dropout=0.5),
        init_sigma=init_sigma,
    )
