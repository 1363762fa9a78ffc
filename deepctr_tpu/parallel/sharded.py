"""Row-sharded embedding tables with all-to-all ID/embedding exchange.

The replacement for the reference's single ``theano.shared``
embedding matrix (SURVEY.md §2.4, BASELINE.json:5): embedding rows are
sharded across the mesh's ``data`` axis with a deterministic modulo hash
(``owner = id % N``), while the dense tower runs data-parallel on the same
devices — the classic DLRM layout (cf. PAPERS.md 2-D sparse parallelism).

Lookup protocol, inside one ``shard_map`` (all static shapes):

1. bucket local ids by owner shard (stable sort + rank-in-bucket),
   fixed per-owner capacity ``C`` with drop-on-overflow (SURVEY.md §7
   "capacity padding + overflow policy"; drops are counted and reported);
2. ``all_to_all`` the id buckets over the mesh axis (rides ICI);
3. local gather from the resident shard (sentinel row ``R`` is a frozen
   zero row serving padded request slots);
4. ``all_to_all`` the gathered rows back; unsort to occurrence order.

Backward runs the same route in reverse: occurrence gradients are bucketed
with the SAME permutation, exchanged, then deduplicated and applied to the
local shard rows by the sparse optimizer — each shard's Adagrad accumulator
lives with its rows, so no optimizer-state traffic ever crosses chips.

Storage layout: logical row ``g`` lives on shard ``g % N`` at local index
``g // N``; the stored global array is ``[N*(R+1), D]`` sharded on axis 0,
where ``R = cdiv(V_padded, N)`` and each shard's extra row ``R`` is the
sentinel.  :func:`pack_table` / :func:`unpack_table` convert to/from the
logical ``[V_padded, D]`` layout (used by checkpointing and FM->FNN init).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.schema import Schema
from ..models.base import Model
from ..ops.split_embed import SplitPlan, assemble_rows
from .comm import exchange_capacity
from .mesh import DATA_AXIS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Stored <-> logical layout
# ---------------------------------------------------------------------------


def shard_rows(vocab_padded: int, num_shards: int) -> int:
    """Logical rows per shard (excluding the sentinel row)."""
    return _cdiv(vocab_padded, num_shards)


def pack_table(logical: jax.Array, num_shards: int) -> jax.Array:
    """[V_padded, D] logical -> [N*(R+1), D] stored (shard-major, sentinel
    zero row appended per shard)."""
    Vp, D = logical.shape
    R = shard_rows(Vp, num_shards)
    g = jnp.arange(Vp)
    stored = jnp.zeros((num_shards, R + 1, D), logical.dtype)
    stored = stored.at[g % num_shards, g // num_shards].set(logical)
    return stored.reshape(num_shards * (R + 1), D)


def unpack_table(stored: jax.Array, vocab_padded: int, num_shards: int) -> jax.Array:
    """Inverse of :func:`pack_table`."""
    R = stored.shape[0] // num_shards - 1
    st = stored.reshape(num_shards, R + 1, -1)
    g = jnp.arange(vocab_padded)
    return st[g % num_shards, g // num_shards]


# ---------------------------------------------------------------------------
# Bucketing (static-shape) and the exchange protocol
# ---------------------------------------------------------------------------


class _Buckets(NamedTuple):
    send: jax.Array      # int32[N, C] local row indices to request from each owner
    order: jax.Array     # int32[M] stable sort permutation by owner
    owner_s: jax.Array   # int32[M] owner of each sorted occurrence
    rank: jax.Array      # int32[M] rank within its owner bucket
    dropped: jax.Array   # int32 scalar — occurrences beyond capacity


def _bucket_by_owner(flat_ids: jax.Array, n: int, sentinel: int, cap: int) -> _Buckets:
    m = flat_ids.shape[0]
    owner = flat_ids % n
    local = flat_ids // n
    order = jnp.argsort(owner, stable=True)
    owner_s = owner[order]
    local_s = local[order]
    counts = jnp.bincount(owner, length=n)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(m, dtype=jnp.int32) - starts[owner_s].astype(jnp.int32)
    send = jnp.full((n, cap + 1), sentinel, jnp.int32)
    send = send.at[owner_s, jnp.minimum(rank, cap)].set(local_s.astype(jnp.int32))
    dropped = (rank >= cap).sum()
    return _Buckets(send[:, :cap], order, owner_s, rank, dropped)


def _exchange_lookup(table_shard: jax.Array, b: _Buckets, cap: int,
                     wire_dtype=None):
    """all_to_all ids -> local gather -> all_to_all rows. Returns
    (occurrence rows [M, D] in original order, recv ids [N, C]).

    ``wire_dtype`` (e.g. bf16) compresses the row payload ON THE WIRE only:
    rows are cast after the local gather and restored to the table dtype
    after the return exchange — the DCN/ICI knob SCALING.md quantifies
    (halves the dominant exchange volume for ~2^-8 relative rounding)."""
    recv = jax.lax.all_to_all(b.send, DATA_AXIS, 0, 0, tiled=True)   # [N, C]
    rows_local = jnp.take(table_shard, recv, axis=0)                 # [N, C, D]
    if wire_dtype is not None:
        rows_local = rows_local.astype(wire_dtype)
    rows_back = jax.lax.all_to_all(rows_local, DATA_AXIS, 0, 0, tiled=True)
    rows_back = rows_back.astype(table_shard.dtype)
    safe_rank = jnp.where(b.rank < cap, b.rank, 0)
    rows_s = rows_back[b.owner_s, safe_rank]                         # [M, D]
    rows_s = jnp.where((b.rank < cap)[:, None], rows_s, 0.0)
    inv = jnp.argsort(b.order, stable=True)
    return rows_s[inv], recv


def _exchange_scatter_grads(g_occ: jax.Array, b: _Buckets, cap: int,
                            wire_dtype=None) -> jax.Array:
    """Route occurrence grads [M, D] back to owner shards -> [N, C, D].

    Each (owner, rank) slot holds exactly one occurrence (ranks are unique
    within an owner bucket), so the wire cast loses only per-element
    precision; duplicate-id ACCUMULATION happens after the exchange in the
    sparse optimizer, in the table dtype (f32)."""
    d = g_occ.shape[-1]
    out_dtype = g_occ.dtype
    if wire_dtype is not None:
        g_occ = g_occ.astype(wire_dtype)
    g_s = g_occ[b.order]
    buf = jnp.zeros((b.send.shape[0], cap + 1, d), g_occ.dtype)
    buf = buf.at[b.owner_s, jnp.minimum(b.rank, cap)].add(g_s)
    buf = buf[:, :cap]
    out = jax.lax.all_to_all(buf, DATA_AXIS, 0, 0, tiled=True)
    return out.astype(out_dtype)


# ---------------------------------------------------------------------------
# Split-embedding support: small fields as all-gathered replicated subtables
# ---------------------------------------------------------------------------
#
# With a SplitPlan (ops/split_embed.py), only BIG fields ride the all-to-all
# exchange.  Small fields' rows — a few hundred KB in total — are all-gathered
# from their resident shards each step and consumed as replicated one-hot
# matmul operands; their gradients are dense per-field [rows, D] tensors,
# psum'd over the data axis (exactly like the dense tower) and applied by
# each shard to its own resident slice.  This removes ~5/6 of the exchange
# volume at iPinYou shape and keeps optimizer state fully shard-local.
#
# Layout fact the slicing relies on: shard o owns global ids {g : g % n == o}
# at local index g // n, so a field's ids form an arithmetic progression with
# step n whose local indices are CONTIGUOUS — one dynamic_slice per field.


def _small_field_geometry(plan: SplitPlan, n: int, r_plus_1: int):
    """Static per-field slice geometry: [(cnt, offset, vocab)] per small
    field, with ``cnt`` resident rows per shard."""
    geo = []
    for f in plan.small:
        cnt = min(_cdiv(f.vocab, n), r_plus_1)
        geo.append((cnt, f.offset, f.vocab))
    return geo


def _gather_small_tables(table_shard: jax.Array, plan: SplitPlan, n: int):
    """All-gather each small field's resident rows.

    Returns (subtables, id_vectors): per field, a replicated
    ``[n*cnt, D]`` shard-major subtable and the (traced) field-local id
    stored at each of its rows; rows holding out-of-field ids get an id
    outside [0, vocab) and therefore never match in the one-hot compare.
    """
    r_plus_1 = table_shard.shape[0]
    d = table_shard.shape[-1]
    me = jax.lax.axis_index(DATA_AXIS)
    owners = jnp.arange(n)
    subs, id_vecs = [], []
    for cnt, off, vocab in _small_field_geometry(plan, n, r_plus_1):
        # first local row holding an id >= off, per owner:
        # q0 = ceil((off - owner) / n), exact in integer math
        q0 = -((owners - off) // n)
        start_vec = jnp.clip(q0, 0, r_plus_1 - cnt)
        sl = jax.lax.dynamic_slice(
            table_shard, (start_vec[me], jnp.int32(0)), (cnt, d)
        )
        gathered = jax.lax.all_gather(sl, DATA_AXIS, axis=0, tiled=False)
        j = jnp.arange(cnt)
        local_ids = (start_vec[:, None] + j[None, :]) * n + owners[:, None] - off
        subs.append(gathered.reshape(n * cnt, d))
        id_vecs.append(local_ids.reshape(-1))
    return subs, id_vecs


def _small_grad_patches(g_small: list, plan: SplitPlan, n: int, r_plus_1: int):
    """psum per-field dense grads and slice out this shard's patch.

    Returns [(local_row_offset, [cnt, D] grad)] for the sparse optimizer.
    Rows inside a patch that hold out-of-field ids receive an exactly-zero
    gradient (their one-hot column never matched), so overlapping patch
    ranges between adjacent fields are no-ops on each other's rows.
    """
    me = jax.lax.axis_index(DATA_AXIS)
    owners = jnp.arange(n)
    patches = []
    for (cnt, off, _vocab), g in zip(
        _small_field_geometry(plan, n, r_plus_1), g_small
    ):
        g = jax.lax.psum(g, DATA_AXIS)  # replicated operand, DP batches
        q0 = -((owners - off) // n)
        start_vec = jnp.clip(q0, 0, r_plus_1 - cnt)
        patches.append((start_vec[me], g.reshape(n, cnt, -1)[me]))
    return patches


# ---------------------------------------------------------------------------
# Sharded train/eval steps
# ---------------------------------------------------------------------------


class ShardedTrainState(NamedTuple):
    step: jax.Array       # replicated int32
    table: jax.Array      # [N*(R+1), D] stored layout, sharded P(data)
    sparse_state: Any     # same layout/sharding as table
    dense: Any            # replicated
    dense_state: Any      # replicated
    rng: jax.Array        # replicated


def _state_specs(state: ShardedTrainState):
    sharded = P(DATA_AXIS)
    rep = P()
    return ShardedTrainState(
        step=rep,
        table=sharded,
        sparse_state=jax.tree_util.tree_map(lambda _: sharded, state.sparse_state),
        dense=jax.tree_util.tree_map(lambda _: rep, state.dense),
        dense_state=jax.tree_util.tree_map(lambda _: rep, state.dense_state),
        rng=rep,
    )


def init_sharded_state(
    model: Model,
    schema: Schema,
    sparse_opt,
    dense_opt,
    mesh: Mesh,
    seed: int = 0,
    table_dtype: str = "f32",
) -> ShardedTrainState:
    """Initialise params and place them: table row-sharded, dense replicated.

    ``table_dtype="bf16"`` stores the shards in bfloat16 (same memory/wire knob
    as train.step.init_state: gathers, the all_gathered small subtables and
    the full-shard Adagrad elementwise stream half the bytes; all math stays
    f32 — the step casts rows after the exchange/gather)."""
    n = int(np.prod(list(mesh.shape.values())))
    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    params = model.init_params(init_rng, schema)
    table = params["table"]
    if table_dtype == "bf16":
        table = table.astype(jnp.bfloat16)
    elif table_dtype != "f32":
        raise ValueError(f"table_dtype {table_dtype!r} (f32|bf16)")
    stored = pack_table(table, n)
    sparse_state = sparse_opt.init(stored)
    dense_state = dense_opt.init(params["dense"])
    shd = NamedSharding(mesh, P(DATA_AXIS))
    rep = NamedSharding(mesh, P())
    return ShardedTrainState(
        step=jax.device_put(jnp.zeros((), jnp.int32), rep),
        table=jax.device_put(stored, shd),
        sparse_state=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shd), sparse_state
        ),
        dense=jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), params["dense"]),
        dense_state=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep), dense_state
        ),
        rng=jax.device_put(rng, rep),
    )


def sharded_state_from_state(state, mesh: Mesh) -> ShardedTrainState:
    """Pack a prepared single-device TrainState into the sharded layout.

    This is how pretraining output, FM->FNN init and checkpoint resume flow
    into the multi-chip path (SURVEY.md §5 checkpoint row): the logical
    [V_padded, D] table (and any table-shaped optimizer leaf, e.g. the
    Adagrad accumulator) is packed shard-major; dense params/optimizer state,
    step counter and RNG are replicated as-is.
    """
    n = int(np.prod(list(mesh.shape.values())))
    table_shape = tuple(state.table.shape)

    def maybe_pack(x):
        x = jnp.asarray(x)
        if x.ndim == 2 and tuple(x.shape) == table_shape:
            return pack_table(x, n)
        return x

    shd = NamedSharding(mesh, P(DATA_AXIS))
    rep = NamedSharding(mesh, P())
    return ShardedTrainState(
        step=jax.device_put(jnp.asarray(state.step, jnp.int32), rep),
        table=jax.device_put(pack_table(jnp.asarray(state.table), n), shd),
        sparse_state=jax.tree_util.tree_map(
            lambda x: jax.device_put(maybe_pack(x), shd), state.sparse_state
        ),
        dense=jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), rep), state.dense
        ),
        dense_state=jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), rep), state.dense_state
        ),
        rng=jax.device_put(jnp.asarray(state.rng), rep),
    )


def host_state_from_sharded(sst: ShardedTrainState, vocab_padded: int, mesh: Mesh):
    """Inverse of :func:`sharded_state_from_state`: gather + unpack to the
    logical single-device TrainState layout (for portable checkpoints — a
    sharded checkpoint loads into an unsharded run and vice versa, on any
    device count)."""
    from ..train.step import TrainState

    n = int(np.prod(list(mesh.shape.values())))
    stored_shape = tuple(sst.table.shape)

    def maybe_unpack(x):
        if getattr(x, "ndim", 0) == 2 and tuple(x.shape) == stored_shape:
            return np.asarray(unpack_table(x, vocab_padded, n))
        return np.asarray(x)

    return TrainState(
        step=np.asarray(sst.step),
        table=maybe_unpack(sst.table),
        sparse_state=jax.tree_util.tree_map(maybe_unpack, sst.sparse_state),
        dense=jax.tree_util.tree_map(np.asarray, sst.dense),
        dense_state=jax.tree_util.tree_map(np.asarray, sst.dense_state),
        rng=np.asarray(sst.rng),
    )


def make_sharded_train_step(
    model: Model,
    schema: Schema,
    sparse_opt,
    dense_opt,
    mesh: Mesh,
    l2: float = 0.0,
    capacity_factor: float = 2.0,
    template_state: ShardedTrainState | None = None,
    split: SplitPlan | None = None,
    exchange_dtype: str = "f32",
):
    """Build the fully-sharded jitted train step.

    Data-parallel batch + row-sharded table + replicated dense tower with
    psum gradient sync (BASELINE.json:5).  Returns
    ``step(state, ids, labels, weights, lr_scale=1.0) -> (state, (loss,
    dropped))`` where ``dropped`` counts capacity-overflow occurrences (zero
    in healthy runs) and ``lr_scale`` applies epoch LR decay uniformly to
    the sparse and dense updates, matching train/step.py.

    With ``split`` (ops/split_embed.py), small fields bypass the all-to-all:
    their rows are all-gathered as replicated subtables (a few hundred KB)
    and their dense per-field gradients are psum'd and applied shard-locally.

    ``exchange_dtype="bf16"`` compresses the row/grad all_to_all payload on
    the wire (gather, cast, exchange, restore) — the dominant cross-host
    volume, see SCALING.md; math stays f32 end to end otherwise.
    """
    n = int(np.prod(list(mesh.shape.values())))
    pad_id = schema.pad_id
    Vp = schema.padded_vocab_size
    R = shard_rows(Vp, n)
    sentinel = R
    use_split = split is not None and split.has_small
    big_slots = (
        jnp.asarray(split.big_slots, jnp.int32) if use_split else None
    )
    if exchange_dtype not in ("f32", "bf16"):
        raise ValueError(f"exchange_dtype {exchange_dtype!r} (f32|bf16)")
    wire_dtype = jnp.bfloat16 if exchange_dtype == "bf16" else None

    def inner(state: ShardedTrainState, ids, labels, weights, lr_scale):
        # shapes here are PER-DEVICE: ids [b_loc, S], table [R+1, D]
        b_loc, S = ids.shape
        d = state.table.shape[-1]
        exch_ids = ids[:, big_slots] if use_split else ids
        m = exch_ids.shape[0] * exch_ids.shape[1]
        # capacity formula shared with the comm-volume accounting
        # (parallel/comm.py) so SCALING.md cannot drift from execution
        cap = exchange_capacity(m, n, capacity_factor)
        rng, step_rng = jax.random.split(state.rng)
        step_rng = jax.random.fold_in(step_rng, jax.lax.axis_index(DATA_AXIS))
        mask = (ids != pad_id).astype(jnp.float32)

        gw = jax.lax.psum(weights.sum(), DATA_AXIS)
        gb = jnp.asarray(b_loc * n, jnp.float32)

        if m > 0:
            flat = exch_ids.reshape(-1)
            buckets = _bucket_by_owner(flat, n, sentinel, cap)
            occ_rows, recv = _exchange_lookup(state.table, buckets, cap,
                                              wire_dtype)
            # cast-early for bf16-stored shards (train.table_dtype): all
            # differentiable math runs f32; only storage/wire are narrow
            occ_rows = occ_rows.astype(jnp.float32)
        else:  # every field is in the matmul class: no exchange at all
            buckets = None
            occ_rows = jnp.zeros((0, d), jnp.float32)
            recv = jnp.zeros((n, 0), jnp.int32)

        def make_loss(rows_builder):
            def loss_fn(*diff_args):
                rows_ = rows_builder(*diff_args[:-1])
                dense_ = diff_args[-1]
                logits = model.apply_rows(
                    dense_, rows_, mask, train=True, rng=step_rng
                )
                ls = jax.nn.log_sigmoid(logits)
                lns = jax.nn.log_sigmoid(-logits)
                per = -(labels * ls + (1.0 - labels) * lns)
                loss_local = (per * weights).sum() / jnp.maximum(gw, 1.0)
                if l2:
                    loss_local = loss_local + l2 * (
                        jnp.square(rows_) * mask[..., None]
                    ).sum() / gb
                return loss_local, logits

            return loss_fn

        if use_split:
            small_tabs, id_vecs = _gather_small_tables(state.table, split, n)
            # (bf16 tables all_gather the narrow subtables, then promote)
            small_tabs = [t.astype(jnp.float32) for t in small_tabs]
            big_rows = occ_rows.reshape(b_loc if m else 0, len(split.big_slots), d)
            if m == 0:
                big_rows = jnp.zeros((b_loc, 0, d), jnp.float32)

            def build_rows(small_tabs_, big_rows_):
                return assemble_rows(
                    small_tabs_, big_rows_, ids, split, small_id_vectors=id_vecs
                )

            (loss_local, _logits), (g_small, g_big, g_dense) = (
                jax.value_and_grad(
                    make_loss(build_rows), argnums=(0, 1, 2), has_aux=True
                )(small_tabs, big_rows, state.dense)
            )
            g_occ = g_big.reshape(-1, d)[:m]
            patches = _small_grad_patches(g_small, split, n, R + 1)
        else:
            rows = occ_rows.reshape(b_loc, S, -1)
            (loss_local, _logits), (g_rows, g_dense) = jax.value_and_grad(
                make_loss(lambda r: r), argnums=(0, 1), has_aux=True
            )(rows, state.dense)
            g_occ = g_rows.reshape(m, -1)
            patches = ()

        # --- dense: psum grads, replicated optax update; lr_scale applies
        # uniformly to both sides, matching train/step.py (epoch LR decay)
        g_dense = jax.lax.psum(g_dense, DATA_AXIS)
        updates, dense_state = dense_opt.update(g_dense, state.dense_state, state.dense)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        dense = optax.apply_updates(state.dense, updates)

        # --- table: route occurrence grads to owner shards, dedupe, update
        if buckets is not None:
            g_recv = _exchange_scatter_grads(g_occ, buckets, cap,
                                             wire_dtype)            # [N, C, D]
            occ_local_ids = recv.reshape(-1)
            occ_grads = g_recv.reshape(occ_local_ids.shape[0], -1)
            dropped = buckets.dropped
        else:
            occ_local_ids = jnp.zeros((0,), jnp.int32)
            occ_grads = jnp.zeros((0, d), jnp.float32)
            dropped = jnp.zeros((), jnp.int32)
        table, sparse_state = sparse_opt.update(
            state.table, state.sparse_state, occ_local_ids, occ_grads,
            lr_scale=lr_scale, patches=patches,
        )

        loss = jax.lax.psum(loss_local, DATA_AXIS)
        dropped = jax.lax.psum(dropped, DATA_AXIS)
        new_state = ShardedTrainState(
            step=state.step + 1,
            table=table,
            sparse_state=sparse_state,
            dense=dense,
            dense_state=dense_state,
            rng=rng,
        )
        return new_state, (loss, dropped)

    def build(state: ShardedTrainState):
        specs = _state_specs(state)
        fn = jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(specs, P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=(specs, (P(), P())),
            check_vma=False,
        )
        return jax.jit(fn, donate_argnums=(0,))

    if template_state is not None:
        built = build(template_state)

        def step_t(state, ids, labels, weights, lr_scale=1.0):
            return built(state, ids, labels, weights,
                         jnp.asarray(lr_scale, jnp.float32))

        return step_t

    _cache: dict = {}

    def step(state, ids, labels, weights, lr_scale=1.0):
        key = jax.tree_util.tree_structure(state)
        if key not in _cache:
            _cache[key] = build(state)
        return _cache[key](state, ids, labels, weights,
                           jnp.asarray(lr_scale, jnp.float32))

    return step


def make_sharded_scan_train_step(
    model: Model,
    schema: Schema,
    sparse_opt,
    dense_opt,
    mesh: Mesh,
    l2: float = 0.0,
    capacity_factor: float = 2.0,
    split: SplitPlan | None = None,
    exchange_dtype: str = "f32",
):
    """T sharded train steps in one ``lax.scan`` dispatch.

    ``scan_step(state, ids [T,B,S], labels [T,B], weights [T,B])`` ->
    ``(state, (losses [T], dropped [T]))`` — same dispatch-amortisation
    rationale as train.step.make_scan_train_step, for the sharded path.
    """
    inner_builder = make_sharded_train_step(
        model, schema, sparse_opt, dense_opt, mesh,
        l2=l2, capacity_factor=capacity_factor, split=split,
        exchange_dtype=exchange_dtype,
    )

    _cache: dict = {}

    def scan_step(state: ShardedTrainState, ids, labels, weights, lr_scale=1.0):
        key = jax.tree_util.tree_structure(state)
        if key not in _cache:
            def jitted(state_, ids_, labels_, weights_, lr_scale_):
                def body(st, batch):
                    st2, (loss, dropped) = inner_builder(st, *batch, lr_scale_)
                    return st2, (loss, dropped)

                return jax.lax.scan(body, state_, (ids_, labels_, weights_))

            _cache[key] = jax.jit(jitted, donate_argnums=(0,))
        return _cache[key](state, ids, labels, weights,
                           jnp.asarray(lr_scale, jnp.float32))

    return scan_step


def make_sharded_eval_step(model: Model, schema: Schema, mesh: Mesh,
                           capacity_factor: float = 2.0,
                           split: SplitPlan | None = None,
                           exchange_dtype: str = "f32"):
    """Sharded forward pass: ``(table_stored, dense, ids) -> logits``."""
    n = int(np.prod(list(mesh.shape.values())))
    pad_id = schema.pad_id
    R = shard_rows(schema.padded_vocab_size, n)
    use_split = split is not None and split.has_small
    big_slots = (
        jnp.asarray(split.big_slots, jnp.int32) if use_split else None
    )
    wire_dtype = jnp.bfloat16 if exchange_dtype == "bf16" else None

    def inner(table, dense, ids):
        b_loc, S = ids.shape
        d = table.shape[-1]
        exch_ids = ids[:, big_slots] if use_split else ids
        m = exch_ids.shape[0] * exch_ids.shape[1]
        cap = exchange_capacity(m, n, capacity_factor)
        if m > 0:
            buckets = _bucket_by_owner(exch_ids.reshape(-1), n, R, cap)
            occ_rows, _ = _exchange_lookup(table, buckets, cap, wire_dtype)
            occ_rows = occ_rows.astype(jnp.float32)  # bf16-stored shards
        else:
            occ_rows = jnp.zeros((b_loc, 0, d), jnp.float32)
        if use_split:
            small_tabs, id_vecs = _gather_small_tables(table, split, n)
            small_tabs = [t.astype(jnp.float32) for t in small_tabs]
            rows = assemble_rows(
                small_tabs,
                occ_rows.reshape(b_loc, len(split.big_slots), d),
                ids,
                split,
                small_id_vectors=id_vecs,
            )
        else:
            rows = occ_rows.reshape(b_loc, S, -1)
        mask = (ids != pad_id).astype(jnp.float32)
        return model.apply_rows(dense, rows, mask, train=False, rng=None)

    def build(dense):
        dense_spec = jax.tree_util.tree_map(lambda _: P(), dense)
        fn = jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), dense_spec, P(DATA_AXIS)),
            out_specs=P(DATA_AXIS),
            check_vma=False,
        )
        return jax.jit(fn)

    _cache: dict = {}

    def eval_step(table, dense, ids):
        key = jax.tree_util.tree_structure(dense)
        if key not in _cache:
            _cache[key] = build(dense)
        return _cache[key](table, dense, ids)

    return eval_step
