"""Per-step communication-volume accounting of the sharded step.

Every byte the sharded step exchanges is closed-form in the step's static
shapes; this module accounts them per collective, device-agnostically.
tools/scaling_report.py renders SCALING.md from these functions and checks
them against the compiled program; tests/test_comm.py pins the formulas
(same capacity formula — imported by parallel/sharded.py, so the two cannot
drift).  Link times are not modelled here: they come from a measured trace.

Exchange inventory of one sharded train step (parallel/sharded.py):

================  =========================  ==========================
collective        payload (per device)       purpose
================  =========================  ==========================
all_to_all        [N, C] int32               big-field id requests
all_to_all        [N, C, D] f32              gathered rows, owner->user
all_to_all        [N, C, D] f32              occurrence grads, user->owner
all_gather x F_s  [cnt_f, D] f32 -> n*cnt_f  small-field subtables
psum x F_s        [n*cnt_f, D] f32           small-field dense grads
psum              dense params               tower grad sync
psum              2 scalars                  loss, drop counter
================  =========================  ==========================

with N = mesh size, C = exchange capacity, D = row width, F_s = number of
small fields under the split plan.  Eval steps run only the first two rows
plus the all_gathers.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def exchange_capacity(m: int, n: int, capacity_factor: float) -> int:
    """Per-owner bucket capacity C for m local occurrences over n shards.

    THE formula used by the sharded step (parallel/sharded.py imports this),
    so the accounting below is definitionally in sync with execution.
    """
    return max(1, min(max(m, 1), int(capacity_factor * _cdiv(max(m, 1), n))))


def _small_field_rows(schema, split, n: int) -> list[int]:
    """Resident rows per shard for each small field (mirrors
    sharded._small_field_geometry)."""
    if split is None or not split.has_small:
        return []
    r_plus_1 = _cdiv(schema.padded_vocab_size, n) + 1
    return [min(_cdiv(f.vocab, n), r_plus_1) for f in split.small]


@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Per-device, per-step exchanged bytes, split by collective.

    ``*_wire`` fields apply the cross-device fraction: an all_to_all keeps
    1/N of the payload local; a ring all-reduce (psum) moves 2*(N-1)/N of
    the operand size per device; an all_gather moves (N-1)/N of the gathered
    result per device.
    """

    n_devices: int
    batch_per_device: int
    capacity: int
    ids_a2a: int            # [N, C] int32, one direction
    rows_a2a_fwd: int       # [N, C, D] f32
    rows_a2a_bwd: int       # [N, C, D] f32
    small_allgather: int    # sum_f (n*cnt_f) * D * 4 (gathered result size)
    small_psum: int         # sum_f (n*cnt_f) * D * 4 (operand size)
    dense_psum: int         # dense param bytes (operand size)

    @property
    def a2a_wire(self) -> int:
        f = (self.n_devices - 1) / self.n_devices
        return int((self.ids_a2a + self.rows_a2a_fwd + self.rows_a2a_bwd) * f)

    @property
    def allgather_wire(self) -> int:
        f = (self.n_devices - 1) / self.n_devices
        return int(self.small_allgather * f)

    @property
    def psum_wire(self) -> int:
        f = 2 * (self.n_devices - 1) / self.n_devices
        return int((self.small_psum + self.dense_psum) * f)

    @property
    def total_wire(self) -> int:
        return self.a2a_wire + self.allgather_wire + self.psum_wire

    @property
    def bytes_per_example(self) -> float:
        return self.total_wire / max(self.batch_per_device, 1)

    def table(self) -> str:
        rows = [
            ("id all_to_all [N,C] i32", self.ids_a2a),
            ("row all_to_all fwd [N,C,D] f32", self.rows_a2a_fwd),
            ("grad all_to_all bwd [N,C,D] f32", self.rows_a2a_bwd),
            ("small-field all_gather", self.small_allgather),
            ("small-field grad psum (operand)", self.small_psum),
            ("dense tower grad psum (operand)", self.dense_psum),
        ]
        out = ["| collective | payload bytes/device | wire bytes/device |",
               "|---|---|---|"]
        f_a2a = (self.n_devices - 1) / self.n_devices
        f_ps = 2 * (self.n_devices - 1) / self.n_devices
        for name, b in rows:
            wire = b * (f_ps if "psum" in name else f_a2a)
            out.append(f"| {name} | {b:,} | {int(wire):,} |")
        out.append(f"| **total wire** |  | **{self.total_wire:,}** |")
        return "\n".join(out)


def comm_volume(
    schema,
    batch_per_device: int,
    n_devices: int,
    capacity_factor: float = 2.0,
    split=None,
    dense_param_bytes: int = 0,
    row_dim: int = 11,
    exchange_bytes: int = 4,
    table_bytes: int = 4,
) -> CommVolume:
    """Closed-form per-device per-step exchange volumes of the sharded step.

    ``split=None`` models the all-exchange path (every slot rides the
    all_to_all); with a SplitPlan only ``split.big_slots`` do.
    ``exchange_bytes``: per-element width of the row/grad all_to_all payload
    (4 = f32, 2 = the bf16 exchange knob ``train.exchange_dtype=bf16``).
    ``table_bytes``: storage width of the table shards (train.table_dtype) —
    the small-field subtables all_gather in the STORED dtype (the step
    promotes to f32 after the gather), while their psum'd gradients are
    always f32.
    """
    n = n_devices
    s_exch = (
        len(split.big_slots) if (split is not None and split.has_small)
        else schema.num_slots
    )
    m = batch_per_device * s_exch
    cap = exchange_capacity(m, n, capacity_factor) if s_exch else 0
    d = row_dim
    small_rows = _small_field_rows(schema, split, n)
    small_bytes = sum(n * cnt * d * table_bytes for cnt in small_rows)
    small_psum_bytes = sum(n * cnt * d * 4 for cnt in small_rows)
    return CommVolume(
        n_devices=n,
        batch_per_device=batch_per_device,
        capacity=cap,
        ids_a2a=n * cap * 4,
        rows_a2a_fwd=n * cap * d * exchange_bytes,
        rows_a2a_bwd=n * cap * d * exchange_bytes,
        small_allgather=small_bytes,
        small_psum=small_psum_bytes,
        dense_psum=dense_param_bytes,
    )


def dense_param_bytes(model, schema) -> int:
    """Byte size of the replicated dense pytree (psum'd every step)."""
    import jax

    params = model.init_params(jax.random.PRNGKey(0), schema)
    return sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(params["dense"])
    )
