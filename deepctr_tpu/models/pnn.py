"""PNN — Product-based Neural Network (IPNN / OPNN) over shared embeddings.

The reference repo's author's follow-up design (Qu et al., ICDM'16,
"Product-based Neural Networks for User Response Prediction") and the
natural extension of the FNN family this framework reproduces (SURVEY.md
§2.3): the first hidden layer consumes the per-field embedding concat
*plus* explicit pairwise product features

    IPNN:  p_ij = <f_i, f_j>                (F(F-1)/2 inner products)
    OPNN:  p    = sum_i f_i (outer) sum_j f_j, compressed as (sum_i f_i)^2
           per coordinate pair -> here the standard D-rank compression
           (sum^2 - sum of squares), the same identity FM uses.

Formulation: both product signals are batched matmuls — IPNN's Gram matrix via one ``bfd,bgd->bfg`` einsum, OPNN's
compressed outer product via the FM sum-of-squares identity — no pairwise
Python loops, static shapes throughout.  Table layout matches FM/FNN
([V+1, 1+k]), so FM checkpoints can seed PNN embeddings exactly like FNN
(``init_fnn_from_fm`` works unchanged).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..data.schema import Schema
from .base import MlpSpec, Params, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class PNNModel:
    """Construct via :func:`make_pnn` to bind the slot->field map."""

    slot_field: tuple[int, ...]
    num_fields: int
    k: int = 10
    product: str = "inner"  # inner (IPNN) | outer (OPNN)
    mlp: MlpSpec = MlpSpec(hidden=(200, 200), activation="relu", dropout=0.5)
    init_sigma: float = 0.01
    name: str = "pnn"

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        return (schema.padded_vocab_size, 1 + self.k)

    def _product_dim(self) -> int:
        if self.product == "inner":
            return self.num_fields * (self.num_fields - 1) // 2
        return 1 + self.k  # compressed outer product is one D-vector

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        V, D = self.table_shape(schema)
        r_tab, r_mlp = jax.random.split(rng)
        table = self.init_sigma * jax.random.normal(r_tab, (V, D), jnp.float32)
        table = table.at[schema.pad_id].set(0.0)
        in_dim = self.num_fields * D + self._product_dim()
        return {"table": table,
                "dense": {"mlp": init_mlp(r_mlp, in_dim, self.mlp)}}

    def apply_rows(self, dense, rows, mask, *, train=False, rng=None):
        # rows: [B, S, D]; pool slots into fields (multi-valued fields sum)
        x = rows * mask[..., None]
        slot_field = jnp.asarray(self.slot_field, jnp.int32)
        onehot = jax.nn.one_hot(slot_field, self.num_fields, dtype=x.dtype)
        fields = jnp.einsum("bsd,sf->bfd", x, onehot)       # [B, F, D]
        flat = fields.reshape(fields.shape[0], -1)          # [B, F*D]

        if self.product == "inner":
            gram = jnp.einsum("bfd,bgd->bfg", fields, fields)  # [B, F, F]
            iu = np.triu_indices(self.num_fields, k=1)
            prods = gram[:, iu[0], iu[1]]                      # [B, F(F-1)/2]
        else:
            s = fields.sum(axis=1)                             # [B, D]
            prods = 0.5 * (s * s - (fields * fields).sum(axis=1))

        z = jnp.concatenate([flat, prods], axis=1)
        return apply_mlp(dense["mlp"], z, self.mlp, train=train, rng=rng)


def make_pnn(
    schema: Schema,
    k: int = 10,
    product: str = "inner",
    mlp: MlpSpec | None = None,
    init_sigma: float = 0.01,
) -> PNNModel:
    if product not in ("inner", "outer"):
        raise ValueError(f"unknown PNN product {product!r} (inner|outer)")
    return PNNModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        k=k,
        product=product,
        mlp=mlp or MlpSpec(hidden=(200, 200), activation="relu", dropout=0.5),
        init_sigma=init_sigma,
        name=f"pnn_{product}",
    )
