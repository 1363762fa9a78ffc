"""Per-host sharded checkpoints for multi-controller training.

The portable checkpoint (utils/checkpoint.py, used by the CLI loops)
gathers the LOGICAL table onto one host — fine single-controller, but in a
multi-controller run no process can address the other hosts' shards, so a
full gather is impossible by construction.  This module implements the
multi-host-native alternative (SURVEY.md §5 failure-detection row, the
"restart-from-checkpoint" mechanism): every process saves exactly its
ADDRESSABLE shards of each sharded leaf (plus its own copy of the
replicated leaves), and on restore each process reloads its slice and the
global arrays are reassembled with
``jax.make_array_from_single_device_arrays`` — no cross-host traffic in
either direction.

Restart contract: the restore mesh must have the same shape and the same
process -> device assignment as the save mesh (a rescheduled job gets the
same topology).  Shards are
keyed by their full per-dim global offsets, so device *ordering* within a
process may differ as long as the assignment does not, and leaves
partitioned along any axis (or replicated across a second mesh axis)
round-trip correctly.

Fault story exercised end to end in tools/multihost_sim.py phase 3: kill
one worker mid-step, detect the stall, restart BOTH workers from the last
per-host checkpoint, and match the uninterrupted trajectory.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def _is_sharded(x) -> bool:
    sh = getattr(x, "sharding", None)
    return sh is not None and not sh.is_fully_replicated


def _shard_key(index: tuple) -> str:
    """Stable key for a shard's global region: per-dim start offsets."""
    return "_".join(str(int(sl.start or 0)) for sl in index)


def save_host_shards(dirpath: str, state, epoch: int = 0) -> str:
    """Write this process's slice of ``state`` to <dir>/proc<k>.npz.

    Every process must call this (collectively, though no communication
    happens); each file is self-contained for its process: sharded leaves
    as one array per addressable shard (keyed by global row offset),
    replicated leaves in full.
    """
    os.makedirs(dirpath, exist_ok=True)
    pid = jax.process_index()
    leaves, _ = jax.tree_util.tree_flatten(state)
    payload: dict = {"__epoch": np.int64(epoch),
                     "__nleaves": np.int64(len(leaves))}
    for i, x in enumerate(leaves):
        if _is_sharded(x):
            for s in x.addressable_shards:
                # key by the FULL index tuple: two addressable shards with
                # the same key cover the same global region (replication
                # across another mesh axis), so the overwrite is identical
                # data; axis-1-partitioned leaves get distinct keys instead
                # of silently colliding on an axis-0-only key
                key = _shard_key(s.index)
                payload[f"s{i}__{key}"] = np.asarray(s.data)
            payload[f"__shape{i}"] = np.asarray(x.shape, np.int64)
        else:
            payload[f"r{i}"] = np.asarray(x)
    path = os.path.join(dirpath, f"proc{pid}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    src = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(src, path)
    return path


def load_host_shards(dirpath: str, like):
    """Rebuild ``like``-shaped global state from this process's file.

    ``like`` provides the tree structure, shardings and dtypes (a freshly
    initialised state on the restore mesh).  Returns (state, epoch).
    """
    pid = jax.process_index()
    z = np.load(os.path.join(dirpath, f"proc{pid}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten(like)
    assert int(z["__nleaves"]) == len(leaves), (
        f"checkpoint has {int(z['__nleaves'])} leaves, state has "
        f"{len(leaves)} — incompatible layout"
    )
    out = []
    for i, x in enumerate(leaves):
        if _is_sharded(x):
            shape = tuple(int(d) for d in z[f"__shape{i}"])
            assert shape == tuple(x.shape), (i, shape, tuple(x.shape))
            idx_map = x.sharding.addressable_devices_indices_map(shape)
            arrs = []
            for dev, idx in idx_map.items():
                key = f"s{i}__{_shard_key(idx)}"
                assert key in z, (
                    f"leaf {i}: shard {key} missing from checkpoint — "
                    f"restore sharding does not match save sharding"
                )
                arrs.append(jax.device_put(z[key], dev))
            out.append(
                jax.make_array_from_single_device_arrays(
                    shape, x.sharding, arrs
                )
            )
        else:
            out.append(jax.device_put(z[f"r{i}"], x.sharding))
    return jax.tree_util.tree_unflatten(treedef, out), int(z["__epoch"])
