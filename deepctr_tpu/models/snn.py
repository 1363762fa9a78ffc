"""SNN — sampling-based fully-connected network with DAE/RBM pretraining.

Reference parity: components C7/C8 (SURVEY.md §2.1, §2.3): the bottom layer
is fully connected over the ENTIRE one-hot vector x (not field-factorised),
sigmoid activation, pretrained unsupervised as a denoising auto-encoder
(SNN-DAE) or an RBM via CD-1 contrastive divergence (SNN-RBM).  Tractability
over the huge sparse input comes from **per-field negative sampling**: each
step touches only the active unit(s) of each field plus ``m`` randomly
sampled inactive units of the same field (m ∈ {1,2,4} in the paper's
study).  After pretraining, the supervised phase fine-tunes exactly like
FNN's top stack.

Design notes: a fully-connected layer over one-hot input IS an
embedding-bag sum, so the weight matrix lives as a ``[V+1, h1]`` table and
reuses the gather + sparse-update path.  Negative sampling runs on-device
with ``jax.random`` (counter-based, reproducible) rather than host NumPy as
the reference does (SURVEY.md §3.4); all candidate sets have static shape
``S + F*m``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.schema import Schema
from .base import MlpSpec, Params, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class SNNModel:
    """Supervised SNN: sigmoid bottom layer over one-hot x, then MLP."""

    hidden1: int = 200
    mlp: MlpSpec = MlpSpec(hidden=(300, 100), activation="tanh", dropout=0.5)
    init_sigma: float = 0.01
    name: str = "snn"

    def table_shape(self, schema: Schema) -> tuple[int, int]:
        return (schema.padded_vocab_size, self.hidden1)

    def init_params(self, rng: jax.Array, schema: Schema) -> Params:
        V, D = self.table_shape(schema)
        r_tab, r_mlp = jax.random.split(rng)
        table = self.init_sigma * jax.random.normal(r_tab, (V, D), jnp.float32)
        table = table.at[schema.pad_id].set(0.0)
        dense = {
            "b1": jnp.zeros((self.hidden1,), jnp.float32),
            "mlp": init_mlp(r_mlp, self.hidden1, self.mlp),
        }
        return {"table": table, "dense": dense}

    def apply_rows(self, dense, rows, mask, *, train=False, rng=None):
        # rows: [B, S, h1]; bottom layer = sigma(sum of active rows + b1)
        z = (rows * mask[..., None]).sum(axis=1) + dense["b1"]
        h = jax.nn.sigmoid(z)
        return apply_mlp(dense["mlp"], h, self.mlp, train=train, rng=rng)


# ---------------------------------------------------------------------------
# Per-field negative sampling (shared by DAE and RBM pretrainers)
# ---------------------------------------------------------------------------


class FieldSampling(NamedTuple):
    """Static per-schema arrays driving on-device negative sampling."""

    field_offset: jax.Array  # int32[F] global-id offset of each field
    field_vocab: jax.Array   # int32[F] vocab size of each field


def field_sampling(schema: Schema) -> FieldSampling:
    return FieldSampling(
        field_offset=jnp.asarray(schema.offsets, jnp.int32),
        field_vocab=jnp.asarray(
            np.asarray([f.vocab_size for f in schema.fields]), jnp.int32
        ),
    )


def sample_negatives(
    rng: jax.Array, fs: FieldSampling, batch: int, m: int, u=None
) -> jax.Array:
    """Draw ``m`` uniform ids per field per example -> int32[B, F*m].

    The reference samples inactive units; drawing uniformly may hit the
    active unit with probability 1/vocab — negligible and harmless (it then
    just appears as both a positive and a candidate), keeping shapes static.

    ``u`` (float[B, F, m] uniforms) overrides the on-device draw — the
    matched-noise parity hook: feeding the SAME uniforms to this and to the
    NumPy oracle makes the two pretrainers' trajectories comparable
    (tests/test_pretrain.py, PARITY.md 'pretrain-matched' rows).
    """
    F = fs.field_offset.shape[0]
    if u is None:
        u = jax.random.uniform(rng, (batch, F, m))
    ids = fs.field_offset[None, :, None] + jnp.floor(
        jnp.asarray(u) * fs.field_vocab[None, :, None].astype(jnp.float32)
    ).astype(jnp.int32)
    return ids.reshape(batch, F * m)


# ---------------------------------------------------------------------------
# DAE pretraining (C7)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DaePretrainer:
    """Denoising auto-encoder over sampled visible units, tied weights.

    Encoder: h = sigma(sum_{kept active} W_i + b1) with inputs dropped at
    rate ``corruption``.  Decoder: for each candidate unit j (the active
    slots as positives, plus m sampled negatives per field),
    x̂_j = sigma(h · W_j + c_j); loss = BCE(x̂, x) over candidates.
    Gradients reach W through both encoder and decoder paths; both flows are
    emitted as occurrence gradients for the sparse optimizer.
    """

    m: int = 2
    corruption: float = 0.3

    def loss_and_grads(
        self, table, dense, batch_ids, pad_id, fs: FieldSampling, rng,
        noise=None,
    ):
        """Returns (loss, occ_ids [B*(S+Fm)], occ_grads, dense_grads).

        dense = {"b1": [h1], "vbias": [V+1]} — vbias is dense-updated (it is
        one float per feature; negligible memory).

        ``noise`` = {"u_keep": [B,S], "u_neg": [B,F,m]} uniforms override the
        on-device draws (matched-noise parity vs the NumPy oracle).
        """
        B, S = batch_ids.shape
        mask = (batch_ids != pad_id).astype(jnp.float32)
        if noise is None:
            r_drop, r_neg = jax.random.split(rng)
            keep = (
                jax.random.bernoulli(
                    r_drop, 1.0 - self.corruption, (B, S)
                ).astype(jnp.float32)
                * mask
            )
            neg_ids = sample_negatives(r_neg, fs, B, self.m)      # [B, Fm]
        else:
            keep = (
                jnp.asarray(noise["u_keep"]) < 1.0 - self.corruption
            ).astype(jnp.float32) * mask
            neg_ids = sample_negatives(None, fs, B, self.m,
                                       u=noise["u_neg"])
        cand_ids = jnp.concatenate([batch_ids, neg_ids], axis=1)  # [B, S+Fm]
        # targets: active slots -> 1 (pad -> weight 0), negatives -> 0
        targets = jnp.concatenate([mask, jnp.zeros_like(neg_ids, jnp.float32)], 1)
        cweight = jnp.concatenate([mask, jnp.ones_like(neg_ids, jnp.float32)], 1)

        def loss_fn(enc_rows, cand_rows, b1, cand_vbias):
            h = jax.nn.sigmoid((enc_rows * keep[..., None]).sum(1) + b1)  # [B,h1]
            logits = jnp.einsum("bh,bch->bc", h, cand_rows) + cand_vbias  # [B,C]
            ls = jax.nn.log_sigmoid(logits)
            lns = jax.nn.log_sigmoid(-logits)
            per = -(targets * ls + (1.0 - targets) * lns)
            return (per * cweight).sum() / jnp.maximum(cweight.sum(), 1.0)

        enc_rows = jnp.take(table, batch_ids, axis=0)
        cand_rows = jnp.take(table, cand_ids, axis=0)
        cand_vbias = jnp.take(dense["vbias"], cand_ids, axis=0)
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3))(
            enc_rows, cand_rows, dense["b1"], cand_vbias
        )
        g_enc, g_cand, g_b1, g_vb = grads
        occ_ids = jnp.concatenate([batch_ids.reshape(-1), cand_ids.reshape(-1)])
        occ_rows = jnp.concatenate(
            [g_enc.reshape(-1, g_enc.shape[-1]), g_cand.reshape(-1, g_cand.shape[-1])]
        )
        return loss, occ_ids, occ_rows, {
            "b1": g_b1,
            "vbias_ids": cand_ids.reshape(-1),
            "vbias_grads": g_vb.reshape(-1),
        }


# ---------------------------------------------------------------------------
# RBM CD-1 pretraining (C8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RbmPretrainer:
    """CD-1 contrastive divergence restricted to sampled visible units.

    v0 over the candidate set (active=1, sampled negatives=0);
    h0 = sigma(W v0 + b1), sampled; v1 = sigma(W^T h0 + c) on candidates;
    h1p = sigma(W v1 + b1).  Updates follow the standard CD-1 statistics
    (positive phase minus negative phase), emitted as occurrence "gradients"
    so the same sparse optimizer applies (sign convention: returned values
    are DESCENT gradients, i.e. negative of the CD update direction).
    """

    m: int = 2

    def loss_and_grads(self, table, dense, batch_ids, pad_id, fs: FieldSampling,
                       rng, noise=None):
        """``noise`` = {"u_neg": [B,F,m], "u_h0": [B,h1]} uniforms override
        the on-device draws (matched-noise parity vs the NumPy oracle)."""
        B, S = batch_ids.shape
        mask = (batch_ids != pad_id).astype(jnp.float32)
        if noise is None:
            r_neg, r_h = jax.random.split(rng)
            neg_ids = sample_negatives(r_neg, fs, B, self.m)
        else:
            neg_ids = sample_negatives(None, fs, B, self.m, u=noise["u_neg"])
        cand_ids = jnp.concatenate([batch_ids, neg_ids], axis=1)   # [B, C]
        v0 = jnp.concatenate([mask, jnp.zeros_like(neg_ids, jnp.float32)], 1)
        cweight = jnp.concatenate([mask, jnp.ones_like(neg_ids, jnp.float32)], 1)

        W_cand = jnp.take(table, cand_ids, axis=0)                 # [B, C, h1]
        c_cand = jnp.take(dense["vbias"], cand_ids, axis=0)        # [B, C]
        b1 = dense["b1"]

        h0p = jax.nn.sigmoid(jnp.einsum("bc,bch->bh", v0 * cweight, W_cand) + b1)
        if noise is None:
            h0 = jax.random.bernoulli(r_h, h0p).astype(jnp.float32)
        else:
            h0 = (jnp.asarray(noise["u_h0"]) < h0p).astype(jnp.float32)
        v1p = jax.nn.sigmoid(jnp.einsum("bh,bch->bc", h0, W_cand) + c_cand)
        v1p = v1p * cweight
        h1p = jax.nn.sigmoid(jnp.einsum("bc,bch->bh", v1p, W_cand) + b1)

        # CD-1 statistics per candidate row j: <v_j h>_data - <v_j h>_model
        pos = (v0 * cweight)[..., None] * h0p[:, None, :]          # [B, C, h1]
        neg = v1p[..., None] * h1p[:, None, :]
        gW = -(pos - neg) / B                                      # descent grad
        g_vb = -((v0 - v1p) * cweight) / B
        g_b1 = -(h0p - h1p).mean(axis=0)
        # reconstruction error as the monitored "loss"
        loss = ((v0 - v1p) ** 2 * cweight).sum() / jnp.maximum(cweight.sum(), 1.0)
        return loss, cand_ids.reshape(-1), gW.reshape(-1, gW.shape[-1]), {
            "b1": g_b1,
            "vbias_ids": cand_ids.reshape(-1),
            "vbias_grads": g_vb.reshape(-1),
        }


def init_pretrain_dense(schema: Schema, hidden1: int) -> dict:
    return {
        "b1": jnp.zeros((hidden1,), jnp.float32),
        "vbias": jnp.zeros((schema.padded_vocab_size,), jnp.float32),
    }
