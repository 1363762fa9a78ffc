"""Common model contract for the LR/FM/FNN/SNN family.

All four reference models (SURVEY.md §2.3) share one structure: gather rows
of a single parameter table by the batch's active feature ids, then apply a
dense head.  We make that structure the framework contract:

    params = {"table": f32[V+1, D], "dense": <pytree>}
    rows   = params["table"][ids]                       # [B, S, D]
    logits = model.apply_rows(dense, rows, mask, ...)   # [B]

This split is what makes sparse training cheap on the device: the train step
differentiates the loss w.r.t. ``rows`` (a small [B, S, D] tensor) and the
dense pytree — never w.r.t. the table — and routes the occurrence gradients
into the deduplicating sparse optimizer (deepctr_tpu/optim/sparse.py).
Masking pad slots inside ``apply_rows`` guarantees the pad row's gradients
are identically zero, keeping it frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import jax
import jax.numpy as jnp
import numpy as np

from ..data.schema import Schema

Params = dict[str, Any]


class Model(Protocol):
    name: str

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        ...

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        ...

    def apply_rows(
        self,
        dense: Any,
        rows: jax.Array,
        mask: jax.Array,
        *,
        train: bool = False,
        rng: jax.Array | None = None,
    ) -> jax.Array:
        ...


def apply_model(model: Model, params: Params, ids: jax.Array, pad_id: int,
                *, train: bool = False, rng: jax.Array | None = None) -> jax.Array:
    """Convenience full forward: gather + head. [B, S] ids -> [B] logits."""
    rows = jnp.take(params["table"], ids, axis=0)
    mask = (ids != pad_id).astype(rows.dtype)
    return model.apply_rows(params["dense"], rows, mask, train=train, rng=rng)


# ---------------------------------------------------------------------------
# Dense MLP head shared by FNN and SNN (SURVEY.md §2.3: tanh hidden layers,
# sigmoid output, dropout regularisation — "dropout outperformed L2").
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MlpSpec:
    hidden: tuple[int, ...] = (300, 100)
    activation: str = "tanh"
    dropout: float = 0.0

    def act(self, x: jax.Array) -> jax.Array:
        if self.activation == "tanh":
            return jnp.tanh(x)
        if self.activation == "relu":
            return jax.nn.relu(x)
        if self.activation == "sigmoid":
            return jax.nn.sigmoid(x)
        raise ValueError(f"unknown activation {self.activation!r}")


def init_mlp(rng: jax.Array, in_dim: int, spec: MlpSpec) -> dict:
    """Glorot-uniform init of hidden stack + scalar-output layer."""
    dims = (in_dim,) + spec.hidden + (1,)
    layers = []
    for i in range(len(dims) - 1):
        rng, sub = jax.random.split(rng)
        fan_in, fan_out = dims[i], dims[i + 1]
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        w = jax.random.uniform(sub, (fan_in, fan_out), jnp.float32, -limit, limit)
        layers.append({"w": w, "b": jnp.zeros((fan_out,), jnp.float32)})
    return {"layers": layers}


def apply_mlp(
    mlp: dict,
    x: jax.Array,
    spec: MlpSpec,
    *,
    train: bool = False,
    rng: jax.Array | None = None,
) -> jax.Array:
    """[B, in_dim] -> [B] logits.

    Runs under the ``dense_tower`` name scope, which device traces carry
    in each op's metadata (tools/tower_share.py attributes time by it)."""
    h = x
    n = len(mlp["layers"])
    with jax.named_scope("dense_tower"):
        for i, layer in enumerate(mlp["layers"]):
            h = h @ layer["w"] + layer["b"]
            if i < n - 1:
                h = spec.act(h)
                if train and spec.dropout > 0.0:
                    if rng is None:
                        raise ValueError("dropout requires an rng in train mode")
                    rng = jax.random.fold_in(rng, i)
                    keep = 1.0 - spec.dropout
                    m = jax.random.bernoulli(rng, keep, h.shape)
                    h = jnp.where(m, h / keep, 0.0)
    return h[:, 0]


# ---------------------------------------------------------------------------
# Loss / regularisation
# ---------------------------------------------------------------------------


def weighted_bce_with_logits(
    logits: jax.Array, labels: jax.Array, weights: jax.Array
) -> jax.Array:
    """Mean binary cross-entropy over weighted examples (pad rows weight 0).

    Matches the reference's xent objective (SURVEY.md §3.1 "loss: xent + L2").
    """
    ls = jax.nn.log_sigmoid(logits)
    lns = jax.nn.log_sigmoid(-logits)
    per = -(labels * ls + (1.0 - labels) * lns)
    denom = jnp.maximum(weights.sum(), 1.0)
    return (per * weights).sum() / denom


def lazy_l2(rows: jax.Array, mask: jax.Array, coeff: float) -> jax.Array:
    """L2 on the rows touched by this batch only ("lazy" L2 — the sparse
    analogue of the reference's weight decay, applied where gradients flow)."""
    if coeff == 0.0:
        return jnp.asarray(0.0, rows.dtype)
    return coeff * (jnp.square(rows) * mask[..., None]).sum() / rows.shape[0]
