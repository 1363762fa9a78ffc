"""Batch scoring (the reference's ``pred_fn`` as a first-class API).

Reference parity: each reference script compiles a ``pred_fn = theano.function
([idx], ŷ)`` used for per-epoch test scoring (SURVEY.md §3.1).  Here scoring
is a standalone surface: load a training checkpoint, jit the forward pass
once, and stream scores for packed id batches or yx/criteo text files —
usable for offline eval and as the building block of a serving replica.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .data.pipeline import minibatches
from .data.schema import Schema
from .models.base import Model


@dataclasses.dataclass
class Scorer:
    """Jit-compiled batch scorer for a trained model.

    ``quantize`` compresses the embedding table for serving replicas:
    - ``"bf16"``: 2x smaller, negligible accuracy impact;
    - ``"int8"``: ~2.6-2.75x smaller (D + pad + 4 scale bytes per row vs
      4D f32), row-wise absmax scales; each row (D int8
      payload + pad + 4 scale bytes) is bitcast into int32 WORDS so the
      big-field gather moves 32-bit words and the row scale rides in the
      same gather.  Unpack happens in-register after the gather; the
      scorer's math stays f32.
    """

    model: Model
    schema: Schema
    table: "np.ndarray"
    dense: dict
    batch_size: int = 8192
    quantize: str | None = None

    def __post_init__(self):
        import jax
        import jax.numpy as jnp

        pad_id = self.schema.pad_id
        model = self.model

        # split lookup: small fields as one-hot matmuls (ops/split_embed.py)
        # — shared by every quantization mode
        from .ops.split_embed import (
            assemble_rows,
            gather_big_rows_sorted,
            make_split_plan,
            slice_small_tables,
        )

        split = make_split_plan(self.schema)

        if self.quantize == "int8":
            # Word-packed layout: each row = D int8 payload + zero pad + 4
            # bytes of the bitcast f32 row scale, padded to a multiple of 4
            # bytes and bitcast to int32 WORDS, so the big-field gather
            # moves full 32-bit words and the row scale rides in the SAME
            # gather.  Unpacking is in-register arithmetic after the
            # gather.  Whether this beats a plain int8 gather on the GPU is
            # still to be measured.
            t = jnp.asarray(self.table, jnp.float32)
            d = t.shape[1]
            pad = -(d + 4) % 4
            words = (d + pad + 4) // 4
            scales = jnp.maximum(jnp.abs(t).max(axis=1, keepdims=True), 1e-12) / 127.0
            q = jnp.clip(jnp.round(t / scales), -127, 127).astype(jnp.int8)
            scale_bytes = jax.lax.bitcast_convert_type(
                scales, jnp.int8
            ).reshape(-1, 4)
            packed8 = jnp.concatenate(
                [q, jnp.zeros((q.shape[0], pad), jnp.int8), scale_bytes], axis=1
            )
            self._table = jax.lax.bitcast_convert_type(
                packed8.reshape(-1, words, 4), jnp.int32
            ).reshape(-1, words)

            def dequant(packed_words):
                lead = packed_words.shape[:-1]
                b = jax.lax.bitcast_convert_type(
                    packed_words.reshape(*lead, words, 1), jnp.int8
                ).reshape(*lead, words * 4)
                rows = b[..., :d].astype(jnp.float32)
                s = jax.lax.bitcast_convert_type(
                    b[..., d + pad:], jnp.float32
                )
                return rows * s[..., None]

            @jax.jit
            def fwd(table, dense, ids):
                if split.has_small:
                    # dequantise each small subtable once per call (a few
                    # hundred KB), then one-hot-matmul in f32; big fields
                    # dequantise only the gathered rows
                    small = [dequant(s) for s in slice_small_tables(table, split)]
                    big = dequant(gather_big_rows_sorted(table, ids, split)[0])
                    rows = assemble_rows(small, big, ids, split)
                else:
                    rows = dequant(jnp.take(table, ids, axis=0))
                mask = (ids != pad_id).astype(jnp.float32)
                return model.apply_rows(dense, rows, mask, train=False, rng=None)
        else:
            dtype = jnp.bfloat16 if self.quantize == "bf16" else jnp.float32
            self._table = jnp.asarray(self.table, dtype)

            @jax.jit
            def fwd(table, dense, ids):
                if split.has_small:
                    # cast-early: cast the small subtables once per call and
                    # the gathered
                    # big rows on the fly, so the one-hot einsums and the
                    # tower see the f32-mode graph (no-op in f32 mode)
                    small = [
                        s.astype(jnp.float32)
                        for s in slice_small_tables(table, split)
                    ]
                    big = gather_big_rows_sorted(table, ids, split)[0].astype(
                        jnp.float32
                    )
                    rows = assemble_rows(small, big, ids, split)
                else:
                    rows = jnp.take(table, ids, axis=0).astype(jnp.float32)
                mask = (ids != pad_id).astype(jnp.float32)
                return model.apply_rows(dense, rows, mask, train=False, rng=None)

        self._fwd = fwd
        self._dense = jax.tree_util.tree_map(jnp.asarray, self.dense)

    @staticmethod
    def from_checkpoint(path: str, model: Model, schema: Schema | None = None,
                        batch_size: int = 8192,
                        quantize: str | None = None) -> "Scorer":
        """Load from a train-state checkpoint written by the CLI/loop.

        The checkpoint manifest records where the (table, dense) leaves sit
        (utils/checkpoint.py), so serving never reconstructs optimizer
        state — no guessing which optimizer trained the model.

        The manifest also carries the training Schema (``schema_json``), so
        a featindex- or criteo-trained checkpoint scores under the exact id
        space it trained with.  A caller-supplied ``schema`` must match the
        manifest's; ``None`` uses the manifest's (error if the checkpoint
        predates schema embedding).
        """
        import jax

        from .utils.checkpoint import load_scoring_params, read_manifest

        manifest = read_manifest(path)
        if "schema_json" in manifest:
            ckpt_schema = Schema.from_json(manifest["schema_json"])
            if schema is None:
                schema = ckpt_schema
            elif schema.to_json() != ckpt_schema.to_json():
                raise ValueError(
                    f"schema mismatch: checkpoint {path} was trained with a "
                    f"different Schema ({ckpt_schema.num_fields} fields, "
                    f"vocab {ckpt_schema.vocab_size}) than the one supplied "
                    f"({schema.num_fields} fields, vocab {schema.vocab_size})"
                )
        elif schema is None:
            raise ValueError(
                f"checkpoint {path} has no embedded schema (pre-schema_json "
                f"format) — pass the training Schema explicitly"
            )

        dense_like = model.init_params(jax.random.PRNGKey(0), schema)["dense"]
        table, dense = load_scoring_params(path, dense_like)
        return Scorer(model=model, schema=schema, table=table,
                      dense=dense, batch_size=batch_size,
                      quantize=quantize)

    # ---- scoring ----------------------------------------------------------

    def logits(self, ids: np.ndarray) -> np.ndarray:
        """Score packed ``int32[N, S]`` ids -> logit per row."""
        out = []
        for b in minibatches(
            ids, np.zeros(len(ids), np.float32), self.batch_size,
            schema=self.schema, shuffle=False, drop_remainder=False,
        ):
            logits = np.asarray(self._fwd(self._table, self._dense, b.ids))
            out.append(logits[b.weights > 0])
        return np.concatenate(out) if out else np.empty(0, np.float32)

    def predict(self, ids: np.ndarray) -> np.ndarray:
        """Click probabilities in [0, 1]."""
        x = np.clip(self.logits(ids), -30, 30)
        return 1.0 / (1.0 + np.exp(-x))

    def score_yx_file(self, path: str, use_native: bool = True) -> Iterator[np.ndarray]:
        """Stream a yx text file -> chunks of probabilities."""
        from .data.pipeline import stream_yx_batches

        for b in stream_yx_batches(
            [path], self.schema, self.batch_size, use_native=use_native
        ):
            logits = np.asarray(self._fwd(self._table, self._dense, b.ids))
            keep = b.weights > 0
            x = np.clip(logits[keep], -30, 30)
            yield 1.0 / (1.0 + np.exp(-x))
