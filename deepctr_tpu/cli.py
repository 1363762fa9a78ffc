"""CLI entry point: ``python -m deepctr_tpu.cli --config configs/fnn.json``.

The replacement of the reference's entry layer (SURVEY.md §1:
``python <Model>.py`` with constants edited in-file).  One binary, config
driven, covering the full model family including the two-phase flows
(FM -> FNN init, DAE/RBM pretrain -> SNN fine-tune) and the sharded
multi-device path.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def build_model(cfg, schema):
    from .models import (
        FMModel,
        LRModel,
        MlpSpec,
        SNNModel,
        make_deepfm,
        make_fnn,
        make_pnn,
    )

    m = cfg.model
    if m.name == "lr":
        return LRModel()
    if m.name == "fm":
        return FMModel(k=m.k, init_sigma=m.init_sigma)
    if m.name == "fnn":
        return make_fnn(
            schema,
            k=m.k,
            mlp=MlpSpec(hidden=tuple(m.hidden), activation=m.activation,
                        dropout=m.dropout),
            init_sigma=m.init_sigma,
        )
    if m.name == "deepfm":
        return make_deepfm(
            schema,
            k=m.k,
            mlp=MlpSpec(hidden=tuple(m.hidden), activation=m.activation,
                        dropout=m.dropout),
            init_sigma=m.init_sigma,
        )
    if m.name in ("pnn", "ipnn", "opnn"):
        return make_pnn(
            schema,
            k=m.k,
            product="outer" if m.name == "opnn" else "inner",
            mlp=MlpSpec(hidden=tuple(m.hidden), activation=m.activation,
                        dropout=m.dropout),
            init_sigma=m.init_sigma,
        )
    if m.name == "snn":
        return SNNModel(
            hidden1=m.hidden1,
            mlp=MlpSpec(hidden=tuple(m.hidden), activation=m.activation,
                        dropout=m.dropout),
            init_sigma=m.init_sigma,
        )
    raise ValueError(
        f"unknown model {m.name!r} (lr|fm|fnn|snn|deepfm|ipnn|opnn)"
    )


def build_optimizers(cfg):
    import optax

    from .optim import make_sparse_optimizer

    kw = {}
    if cfg.optim.sparse == "adagrad":
        kw = {"eps": cfg.optim.eps, "mode": cfg.optim.sparse_mode}
    sparse = make_sparse_optimizer(cfg.optim.sparse, cfg.optim.sparse_lr, **kw)
    dense_factory = getattr(optax, cfg.optim.dense, None)
    if dense_factory is None:
        raise ValueError(f"unknown optax optimizer {cfg.optim.dense!r}")
    return sparse, dense_factory(cfg.optim.dense_lr)


def load_data(cfg):
    """Returns (schema, train_ids, train_labels, test_ids, test_labels).

    With ``data.stream=true`` the second element is a
    ``data.stream.StreamSource`` (and the third is None): training streams
    the shard files through the native parser with bounded host RAM instead
    of materializing the dataset (the Criteo-scale path, BASELINE.json:11).
    """
    from .data import Schema, ipinyou_like_schema, synthetic
    from .data.cache import cache_text_file, read_cache

    d = cfg.data
    if d.format not in ("yx", "criteo"):
        raise ValueError(f"unknown data format {d.format!r} (yx|criteo)")
    if d.stream and not d.train_path:
        raise ValueError("data.stream=true requires data.train_path "
                         "(shard file, glob, or comma list)")
    fi = None
    if d.featindex_path:
        # real-data on-ramp: make-ipinyou-data featindex defines BOTH the
        # schema and the yx-id remap (data/featindex.py)
        if d.format != "yx":
            raise ValueError("data.featindex_path requires data.format=yx")
        from .data.featindex import load_featindex

        fi = load_featindex(d.featindex_path, max_len=d.featindex_max_len)
        schema = fi.schema
    elif d.schema_path:
        with open(d.schema_path) as f:
            schema = Schema.from_json(f.read())
    elif d.format == "criteo":
        from .data.criteo import criteo_schema

        schema = criteo_schema(d.criteo_cat_buckets)
    else:
        schema = ipinyou_like_schema()

    if d.train_path is None:
        ds = synthetic.generate(
            schema, num_examples=d.synthetic_examples, seed=d.synthetic_seed,
            teacher=d.synthetic_teacher,
        )
        n = ds.ids.shape[0]
        cut = int(n * (1 - d.test_fraction))
        return schema, ds.ids[:cut], ds.labels[:cut], ds.ids[cut:], ds.labels[cut:]

    def read(path):
        if fi is not None:
            from .data import featindex as fidx

            if d.use_cache:
                return read_cache(
                    fidx.cache_yx_file(path, fi, d.featindex_path)
                )[:2]
            labels, ids = fidx.parse_yx_file(path, fi)
            return ids, labels
        if d.use_cache:
            return read_cache(
                cache_text_file(path, schema, fmt=d.format,
                                use_native=d.use_native_parser)
            )[:2]
        if d.format == "criteo":
            from .data.criteo import parse_criteo_file

            labels, ids = parse_criteo_file(
                path, schema, use_native=d.use_native_parser
            )
        else:
            from .data import parser

            labels, ids = parser.parse_yx_file(path, schema)
        return ids, labels

    if d.stream:
        if not d.test_path:
            raise ValueError(
                "data.stream=true requires data.test_path (the eval set is "
                "the only part materialized in RAM)"
            )
        from .data.stream import StreamSource

        # multi-controller runs: each process streams a DISJOINT slice of
        # the per-epoch shard permutation and produces only its local share
        # of the global batch (assembled process-locally in _run_sharded) —
        # no host parses another host's data (SURVEY.md §2.4 multi-host row)
        import jax as _jax

        pc = _jax.process_count()
        pi = _jax.process_index() if pc > 1 else 0
        if pc > 1 and cfg.train.batch_size % pc:
            raise ValueError(
                f"train.batch_size {cfg.train.batch_size} must divide by "
                f"process_count {pc}"
            )
        source = StreamSource(
            paths=d.train_path,
            schema=schema,
            batch_size=cfg.train.batch_size // (pc if pc > 1 else 1),
            fmt="yx-featindex" if fi is not None else d.format,
            buffer_rows=d.stream_buffer_rows,
            seed=cfg.train.seed,
            use_native=d.use_native_parser,
            featindex=fi,
            process_index=pi,
            process_count=pc if pc > 1 else 1,
        )
        te_ids, te_labels = read(d.test_path)
        return schema, source, None, te_ids, te_labels

    tr_ids, tr_labels = read(d.train_path)
    if d.test_path:
        te_ids, te_labels = read(d.test_path)
    else:
        n = tr_ids.shape[0]
        cut = int(n * (1 - d.test_fraction))
        tr_ids, te_ids = tr_ids[:cut], tr_ids[cut:]
        tr_labels, te_labels = tr_labels[:cut], tr_labels[cut:]
    return schema, tr_ids, tr_labels, te_ids, te_labels


def run(cfg) -> dict:
    import jax

    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if cfg.train.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if cfg.train.distributed:
        # multi-host: each host runs this same program.  A failure here
        # means the cluster is not what the config says; training on one
        # process instead would silently change the run, so it raises.
        jax.distributed.initialize()

    from .train import fit, init_state, pretrain_snn
    from .utils.checkpoint import (
        init_fnn_from_fm,
        init_snn_from_pretrain,
        load_fm_embeddings,
        save_train_state,
    )
    from .utils.logging import MetricsLogger

    schema, tr_ids, tr_labels, te_ids, te_labels = load_data(cfg)
    from .data.stream import StreamSource

    train_source = tr_ids if isinstance(tr_ids, StreamSource) else None
    if train_source is not None:
        tr_ids = tr_labels = None
    model = build_model(cfg, schema)
    sparse_opt, dense_opt = build_optimizers(cfg)
    logger = MetricsLogger(cfg.train.metrics_path, echo=True)

    state = init_state(
        model, schema, sparse_opt, dense_opt, seed=cfg.train.seed,
        table_dtype=cfg.train.table_dtype,
    )
    resumed = False
    start_epoch = 0
    if (
        cfg.train.resume
        and cfg.train.checkpoint_path
        and __import__("os").path.exists(cfg.train.checkpoint_path)
    ):
        from .utils.checkpoint import load_train_state, read_manifest

        state = load_train_state(cfg.train.checkpoint_path, state)
        start_epoch = int(read_manifest(cfg.train.checkpoint_path).get("epoch", 0))
        resumed = True
        logger.log({"event": "resumed", "path": cfg.train.checkpoint_path,
                    "step": int(state.step), "epoch": start_epoch})

    # two-phase flows (skipped when resuming: the checkpoint already
    # contains the initialised/fine-tuned tables)
    if not resumed and cfg.model.name == "fnn" and cfg.model.init_from:
        fm_table = load_fm_embeddings(cfg.model.init_from)
        params = init_fnn_from_fm(
            {"table": state.table, "dense": state.dense}, fm_table
        )
        state = state._replace(table=params["table"])
        logger.log({"event": "init_from_fm", "path": cfg.model.init_from})
    if not resumed and cfg.model.name == "snn" and cfg.train.pretrain:
        if train_source is not None:
            raise ValueError(
                "SNN pretraining iterates the training ids in RAM; use "
                "data.stream=false (or pretrain on a subsample file first "
                "and pass model.init_from)"
            )
        from .models import DaePretrainer, RbmPretrainer

        pre = (
            DaePretrainer(m=cfg.train.pretrain_m,
                          corruption=cfg.train.pretrain_corruption)
            if cfg.train.pretrain == "dae"
            else RbmPretrainer(m=cfg.train.pretrain_m)
        )
        table, b1 = pretrain_snn(
            pre,
            schema,
            cfg.model.hidden1,
            tr_ids,
            sparse_opt=sparse_opt,
            dense_lr=cfg.train.pretrain_lr,
            batch_size=cfg.train.batch_size,
            epochs=cfg.train.pretrain_epochs,
            seed=cfg.train.seed,
            logger=logger,
        )
        params = init_snn_from_pretrain(
            {"table": state.table, "dense": state.dense}, table, b1
        )
        state = state._replace(table=params["table"], dense=params["dense"])
        logger.log({"event": "init_from_pretrain", "kind": cfg.train.pretrain})

    if cfg.train.profile_dir:
        jax.profiler.start_trace(cfg.train.profile_dir)
    ckpt_meta = {"sparse_opt": cfg.optim.sparse, "model": cfg.model.name}
    if cfg.train.sharded:
        result = _run_sharded(
            cfg, model, schema, sparse_opt, dense_opt,
            tr_ids, tr_labels, te_ids, te_labels, logger, state,
            start_epoch=start_epoch, ckpt_meta=ckpt_meta,
            train_source=train_source,
        )
    else:
        def on_epoch(epoch, st, rec):
            # heartbeat + periodic checkpoint (restart-from-checkpoint
            # fault tolerance, SURVEY.md §5)
            logger.log({"event": "heartbeat", "epoch": epoch,
                        "step": int(st.step)})
            if (
                cfg.train.checkpoint_path
                and (epoch + 1) % max(cfg.train.checkpoint_every, 1) == 0
            ):
                save_train_state(cfg.train.checkpoint_path, st,
                                 epoch=epoch + 1, meta=ckpt_meta,
                                 schema=schema)

        res = fit(
            model,
            schema,
            tr_ids,
            tr_labels,
            te_ids,
            te_labels,
            sparse_opt=sparse_opt,
            dense_opt=dense_opt,
            batch_size=cfg.train.batch_size,
            epochs=cfg.train.epochs,
            l2=cfg.optim.l2,
            seed=cfg.train.seed,
            early_stop_patience=cfg.train.early_stop_patience,
            lr_decay=cfg.train.lr_decay,
            scan_steps=cfg.train.scan_steps,
            split_threshold=cfg.train.split_threshold,
            state=state,
            logger=logger,
            prefetch=cfg.train.prefetch,
            on_epoch=on_epoch,
            start_epoch=start_epoch,
            train_source=train_source,
        )
        if cfg.train.checkpoint_path:
            epochs_done = start_epoch + sum(
                1 for r in res.history if not r.get("eval_only")
            )
            save_train_state(cfg.train.checkpoint_path, res.state,
                             epoch=epochs_done, meta=ckpt_meta, schema=schema)
            if cfg.model.name == "fm":
                from .utils.checkpoint import save_fm_embeddings

                save_fm_embeddings(
                    cfg.train.checkpoint_path + ".fm_table", res.state.table
                )
        result = {"best_auc": res.best_auc, "best_epoch": res.best_epoch,
                  "history": res.history}
    if cfg.train.profile_dir:
        jax.profiler.stop_trace()
    logger.log({"event": "done", "best_auc": result["best_auc"]})
    logger.close()
    return result


def _run_sharded(cfg, model, schema, sparse_opt, dense_opt,
                 tr_ids, tr_labels, te_ids, te_labels, logger, state,
                 start_epoch: int = 0, ckpt_meta: dict | None = None,
                 train_source=None):
    """Sharded training loop (row-sharded tables over the device mesh).

    Feature parity with the single-device loop (train/loop.py): consumes the
    prepared state (pretraining / FM init / checkpoint resume), epoch LR
    decay, ``lax.scan``-fused multi-step dispatch, background device
    prefetch, heartbeat + periodic portable checkpoints, early stopping.
    """
    import time

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .data.pipeline import DevicePrefetcher, minibatches
    from .parallel import (
        DATA_AXIS,
        assemble_process_local,
        host_state_from_sharded,
        make_data_mesh,
        make_sharded_eval_step,
        make_sharded_scan_train_step,
        make_sharded_train_step,
        shard_batch_arrays,
        sharded_state_from_state,
    )
    from .utils import metrics as M
    from .utils.checkpoint import save_train_state

    from .ops.split_embed import make_split_plan

    split = (
        make_split_plan(schema, cfg.train.split_threshold)
        if cfg.train.split_threshold > 0
        else None
    )
    mesh = make_data_mesh(cfg.train.num_devices)
    # the prepared single-device state (with any pretraining/FM-init/resume
    # applied in run()) is the source of truth — pack it onto the mesh
    sstate = sharded_state_from_state(state, mesh)
    # multi-controller resume: per-host shard files supersede the packed
    # state (each process reloads only its own slice)
    hs_dir = (cfg.train.checkpoint_path + ".hostshards"
              if cfg.train.checkpoint_path else None)
    if jax.process_count() > 1 and hs_dir and os.path.isdir(hs_dir):
        from .parallel import load_host_shards

        sstate, start_epoch = load_host_shards(hs_dir, sstate)
        logger.log({"event": "resumed_hostshards", "epoch": start_epoch})
    step = make_sharded_train_step(
        model, schema, sparse_opt, dense_opt, mesh,
        l2=cfg.optim.l2, capacity_factor=cfg.train.capacity_factor,
        split=split, exchange_dtype=cfg.train.exchange_dtype,
    )
    scan_steps = cfg.train.scan_steps
    scan_step = (
        make_sharded_scan_train_step(
            model, schema, sparse_opt, dense_opt, mesh,
            l2=cfg.optim.l2, capacity_factor=cfg.train.capacity_factor,
            split=split, exchange_dtype=cfg.train.exchange_dtype,
        )
        if scan_steps > 1
        else None
    )
    eval_step = make_sharded_eval_step(
        model, schema, mesh, capacity_factor=cfg.train.capacity_factor,
        split=split, exchange_dtype=cfg.train.exchange_dtype,
    )
    batch_sharding = NamedSharding(mesh, P(DATA_AXIS))
    scan_sharding = NamedSharding(mesh, P(None, DATA_AXIS))
    state = sstate
    history = []
    best_auc, best_epoch, since = -np.inf, -1, 0
    batch_size = cfg.train.batch_size
    # a StreamSource in a multi-controller run produces LOCAL batches
    # (batch_size // process_count rows per host) — every input path below
    # must assemble them process-locally; staging a local array through the
    # global-batch helpers would silently treat B/pc rows as the whole
    # batch (wrong data, no error)
    proc_local = jax.process_count() > 1 and train_source is not None

    # on-device streaming AUC: histograms accumulate on the sharded
    # logits and only two [num_bins] vectors ever reach the host
    # (SURVEY.md §5 observability row); logloss accumulates likewise
    @jax.jit
    def _accum(st, logits, labels, weights):
        st2 = M.auc_state_update(st, logits, labels, weights)
        ls = jax.nn.log_sigmoid(logits)
        lns = jax.nn.log_sigmoid(-logits)
        ll = -(labels * ls + (1 - labels) * lns)
        return st2, (ll * weights).sum(), weights.sum()

    def sharded_eval(st):
        auc_state = M.auc_state_init()
        ll_sum, w_sum = 0.0, 0.0
        for b in minibatches(
            te_ids, te_labels, batch_size, schema=schema,
            shuffle=False, drop_remainder=False,
        ):
            ids_d, y_d, w_d = shard_batch_arrays(mesh, b.ids, b.labels, b.weights)
            logits = eval_step(st.table, st.dense, ids_d)
            auc_state, ll_b, w_b = _accum(auc_state, logits, y_d, w_d)
            ll_sum += float(ll_b)
            w_sum += float(w_b)
        return {"auc": M.auc_state_finalize(auc_state),
                "logloss": ll_sum / max(w_sum, 1.0)}

    epochs_done = start_epoch
    for epoch in range(start_epoch, cfg.train.epochs):
        t0 = time.perf_counter()
        lr_scale = cfg.train.lr_decay ** epoch
        n_b, loss_sum, dropped_sum = 0, 0.0, 0
        if scan_step is not None and train_source is not None:
            it = train_source.scan_chunks(epoch, scan_steps)
            if cfg.train.prefetch:
                # process_axis=1: in a multi-controller run each host stages
                # only its own [T, B_local, S] slice of the global batch
                it = DevicePrefetcher(it, depth=2, sharding=scan_sharding,
                                      process_axis=1)
            elif proc_local:
                it = (
                    (nb, assemble_process_local(scan_sharding, i_t, l_t, wt_t,
                                                batch_axis=1))
                    for nb, (i_t, l_t, wt_t) in it
                )
            for nb, (ids_t, y_t, w_t) in it:
                state, (losses, dropped) = scan_step(
                    state, ids_t, y_t, w_t, lr_scale
                )
                loss_sum += float(np.asarray(losses)[:nb].sum())
                dropped_sum += int(np.asarray(dropped).sum())
                n_b += nb
        elif scan_step is not None:
            S = tr_ids.shape[1]
            n = tr_ids.shape[0]
            order = np.arange(n)
            np.random.default_rng(cfg.train.seed + epoch).shuffle(order)

            def chunks():
                chunk = scan_steps * batch_size
                for start in range(0, n - batch_size + 1, chunk):
                    sel = order[start : start + chunk]
                    nb = len(sel) // batch_size
                    sel = sel[: nb * batch_size]
                    if nb == 0:
                        return
                    ids_t = tr_ids[sel].reshape(nb, batch_size, S)
                    y_t = tr_labels[sel].reshape(nb, batch_size)
                    w_t = np.ones((nb, batch_size), np.float32)
                    if nb < scan_steps:  # pad to the compiled T, weight 0
                        padb = scan_steps - nb
                        ids_t = np.concatenate(
                            [ids_t, np.full((padb, batch_size, S),
                                            schema.pad_id, np.int32)]
                        )
                        y_t = np.concatenate(
                            [y_t, np.zeros((padb, batch_size), np.float32)]
                        )
                        w_t = np.concatenate(
                            [w_t, np.zeros((padb, batch_size), np.float32)]
                        )
                    yield nb, (ids_t, y_t, w_t)

            it = chunks()
            if cfg.train.prefetch:
                # (nb, (ids,y,w)) tuples: the prefetcher device_puts the
                # arrays with the [T, B, S] scan sharding, passes nb through
                it = DevicePrefetcher(it, depth=2, sharding=scan_sharding)
            for nb, (ids_t, y_t, w_t) in it:
                state, (losses, dropped) = scan_step(
                    state, ids_t, y_t, w_t, lr_scale
                )
                loss_sum += float(np.asarray(losses)[:nb].sum())
                dropped_sum += int(np.asarray(dropped).sum())
                n_b += nb
        else:
            it = (
                train_source.batches(epoch)
                if train_source is not None
                else minibatches(
                    tr_ids, tr_labels, batch_size, schema=schema,
                    shuffle=True, seed=cfg.train.seed + epoch,
                    drop_remainder=True,
                )
            )
            if cfg.train.prefetch:
                it = DevicePrefetcher(it, depth=2, sharding=batch_sharding,
                                      process_axis=0 if proc_local else None)
            for b in it:
                if cfg.train.prefetch:
                    ids, y, w = b.ids, b.labels, b.weights
                elif proc_local:
                    ids, y, w = assemble_process_local(
                        batch_sharding, b.ids, b.labels, b.weights
                    )
                else:
                    ids, y, w = shard_batch_arrays(
                        mesh, b.ids, b.labels, b.weights
                    )
                state, (loss, dropped) = step(state, ids, y, w, lr_scale)
                loss_sum += float(loss)
                dropped_sum += int(dropped)
                n_b += 1
        jax.block_until_ready(state.table)
        dt = time.perf_counter() - t0
        epochs_done = epoch + 1
        rec = {
            "epoch": epoch,
            "train_loss": loss_sum / max(n_b, 1),
            "dropped_ids": dropped_sum,
            "examples_per_s": n_b * cfg.train.batch_size / max(dt, 1e-9),
            **sharded_eval(state),
        }
        history.append(rec)
        logger.log(rec)
        # heartbeat + periodic portable checkpoint (fault tolerance,
        # SURVEY.md §5 failure row) — same contract as the unsharded loop;
        # the checkpoint is saved in the logical single-device layout so it
        # resumes on any device count (or unsharded)
        logger.log({"event": "heartbeat", "epoch": epoch,
                    "step": int(state.step)})
        if (
            cfg.train.checkpoint_path
            and (epoch + 1) % max(cfg.train.checkpoint_every, 1) == 0
        ):
            if jax.process_count() > 1:
                # multi-controller: the portable gather is impossible (no
                # process addresses remote shards) — save per-host shard
                # files instead (parallel/hostckpt.py; kill+restore drilled
                # in tools/multihost_sim.py phase 3)
                from .parallel import save_host_shards

                save_host_shards(cfg.train.checkpoint_path + ".hostshards",
                                 state, epoch=epoch + 1)
            else:
                save_train_state(
                    cfg.train.checkpoint_path,
                    host_state_from_sharded(state, schema.padded_vocab_size,
                                            mesh),
                    epoch=epoch + 1, meta=ckpt_meta, schema=schema,
                )
        if rec["auc"] > best_auc:
            best_auc, best_epoch, since = rec["auc"], epoch, 0
        else:
            since += 1
            if since > cfg.train.early_stop_patience:
                break
    if not history:  # resumed past the epoch target: evaluate only
        ev = sharded_eval(state)
        rec = {"epoch": start_epoch, "eval_only": True, **ev}
        history.append(rec)
        logger.log(rec)
        best_auc, best_epoch = ev["auc"], start_epoch
    if cfg.train.checkpoint_path:
        if jax.process_count() > 1:
            from .parallel import save_host_shards

            save_host_shards(cfg.train.checkpoint_path + ".hostshards",
                             state, epoch=epochs_done)
            logger.log({"event": "saved_hostshards", "epoch": epochs_done})
        else:
            host_state = host_state_from_sharded(
                state, schema.padded_vocab_size, mesh
            )
            save_train_state(cfg.train.checkpoint_path, host_state,
                             epoch=epochs_done, meta=ckpt_meta, schema=schema)
            if cfg.model.name == "fm":
                from .utils.checkpoint import save_fm_embeddings

                save_fm_embeddings(
                    cfg.train.checkpoint_path + ".fm_table", host_state.table
                )
    return {"best_auc": float(best_auc), "best_epoch": best_epoch,
            "history": history}


def main(argv=None):
    from .config import RunConfig

    ap = argparse.ArgumentParser(
        prog="deepctr_tpu",
        description="CTR training and scoring (LR/FM/FNN/SNN/DeepFM/PNN)",
    )
    ap.add_argument("--config", help="JSON config path (defaults applied)")
    ap.add_argument(
        "overrides", nargs="*",
        help="dotted overrides, e.g. model.name=fm train.epochs=3",
    )
    ap.add_argument("--print-config", action="store_true")
    ap.add_argument(
        "--score", metavar="YX_FILE",
        help="score a yx file with the checkpoint at train.checkpoint_path "
        "and print one probability per line",
    )
    args = ap.parse_args(argv)

    cfg = RunConfig.load(args.config) if args.config else RunConfig()
    cfg = cfg.apply_overrides(args.overrides)
    if args.print_config:
        print(cfg.to_json())
        return 0
    if args.score:
        return score(cfg, args.score)
    run(cfg)
    return 0


def score(cfg, yx_path: str) -> int:
    """Offline scoring surface (the reference's pred_fn role).

    The schema comes from the checkpoint manifest (the exact id space the
    model trained with — including featindex- and criteo-derived schemas);
    config-derived schemas are only a fallback for pre-``schema_json``
    checkpoints.  With ``data.featindex_path`` set, the yx file's raw
    make-ipinyou-data indices are remapped through the featindex exactly as
    at training time.
    """
    from .data import Schema
    from .serving import Scorer
    from .utils.checkpoint import read_manifest

    if not cfg.train.checkpoint_path:
        raise SystemExit("--score requires train.checkpoint_path")
    manifest = read_manifest(cfg.train.checkpoint_path)

    fi = None
    if cfg.data.featindex_path:
        from .data.featindex import load_featindex

        fi = load_featindex(
            cfg.data.featindex_path, max_len=cfg.data.featindex_max_len
        )
    if "schema_json" in manifest:
        schema = Schema.from_json(manifest["schema_json"])
        if fi is not None and fi.schema.to_json() != schema.to_json():
            raise SystemExit(
                "featindex schema does not match the checkpoint's training "
                "schema — regenerated featindex? Retrain or point "
                "data.featindex_path at the file used for training."
            )
    elif fi is not None:
        schema = fi.schema
    else:
        schema = _load_schema_only(cfg)
    model = build_model(cfg, schema)
    scorer = Scorer.from_checkpoint(
        cfg.train.checkpoint_path, model, schema, batch_size=cfg.train.batch_size
    )
    if fi is not None:
        from .data import featindex as fidx

        _, ids = fidx.parse_yx_file(yx_path, fi)
        for p in scorer.predict(ids):
            print(f"{p:.6f}")
        return 0
    for chunk in scorer.score_yx_file(yx_path, cfg.data.use_native_parser):
        for p in chunk:
            print(f"{p:.6f}")
    return 0


def _load_schema_only(cfg):
    """Config-derived schema — fallback for checkpoints without schema_json."""
    from .data import Schema, ipinyou_like_schema

    if cfg.data.schema_path:
        with open(cfg.data.schema_path) as f:
            return Schema.from_json(f.read())
    if cfg.data.format == "criteo":
        from .data.criteo import criteo_schema

        return criteo_schema(cfg.data.criteo_cat_buckets)
    return ipinyou_like_schema()


if __name__ == "__main__":
    sys.exit(main())
