"""Parallelism: device meshes, data-parallel steps, row-sharded tables.

Reference parity note (SURVEY.md §2.4): the reference has NO parallelism —
this package maps the north star's parallel capabilities onto a device mesh.
TP/PP/CP/EP/sequence parallelism are explicit non-goals (no sequence axis
exists in fixed-field CTR data); the scaling axes are batch (DP) and
embedding-table rows (row sharding + all-to-all).
"""

from .hostckpt import load_host_shards, save_host_shards
from .mesh import (DATA_AXIS, assemble_process_local, data_sharding,
                   make_data_mesh, replicated, shard_batch_arrays)
from .comm import CommVolume, comm_volume, dense_param_bytes, exchange_capacity
from .dp import make_dp_train_step, replicate_state
from .sharded import (
    ShardedTrainState,
    host_state_from_sharded,
    init_sharded_state,
    make_sharded_eval_step,
    make_sharded_scan_train_step,
    make_sharded_train_step,
    pack_table,
    shard_rows,
    sharded_state_from_state,
    unpack_table,
)

__all__ = [
    "DATA_AXIS",
    "data_sharding",
    "assemble_process_local",
    "load_host_shards",
    "save_host_shards",
    "make_data_mesh",
    "replicated",
    "shard_batch_arrays",
    "make_dp_train_step",
    "replicate_state",
    "ShardedTrainState",
    "host_state_from_sharded",
    "sharded_state_from_state",
    "init_sharded_state",
    "make_sharded_eval_step",
    "make_sharded_scan_train_step",
    "make_sharded_train_step",
    "pack_table",
    "shard_rows",
    "unpack_table",
    "CommVolume",
    "comm_volume",
    "dense_param_bytes",
    "exchange_capacity",
]
