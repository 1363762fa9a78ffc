"""Extended benchmark suite -> a JSON file of results.

Covers the three BASELINE.json:2 metric families beyond bench.py's single
headline line: per-model training throughput, embedding lookups/s, host
parser throughput (native C++ vs NumPy), and kernel microbenchmarks.

Timing protocol: every device measurement runs T and 2T steps inside one
``lax.scan`` (or one fused jit), each ending in a host fetch, and reports
the marginal cost.  Whether plain ``block_until_ready`` timing agrees on the
GPU is still to be checked against a profiler trace.

Run: python tools/bench_suite.py --sections models,full
     (results accumulate in the --out JSON file)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

import numpy as np

# scratch data files, reused across invocations on one machine
_TMP = tempfile.gettempdir()


def _marginal(run, t_small, t_big):
    """run(count) -> seconds; returns marginal seconds per unit."""
    run(t_small)  # compile small
    run(t_big)    # compile big
    a = run(t_small)
    b = run(t_big)
    return max(b - a, 1e-9) / (t_big - t_small)


def bench_models(results):
    import jax
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_like_schema, synthetic
    from deepctr_tpu.models import FMModel, LRModel, make_deepfm, make_fnn, MlpSpec
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_like_schema()
    B, T = 8192, 8  # small T: scan compile is expensive; marginal method
    # still cancels fixed overhead via the 2T run
    ds = synthetic.generate(schema, num_examples=B * 2 * T, k=4, seed=3)

    def stacked(c):
        out = (
            jnp.asarray(ds.ids[: c * B]).reshape(c, B, -1),
            jnp.asarray(ds.labels[: c * B]).reshape(c, B),
            jnp.ones((c, B), jnp.float32),
        )
        float(out[0].sum())
        return out

    models = {
        "lr": LRModel(),
        "fm": FMModel(k=10),
        "fnn": make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5)),
        "deepfm": make_deepfm(schema, k=10),
    }
    from deepctr_tpu.ops.split_embed import make_split_plan

    split = make_split_plan(schema)
    for name, model in models.items():
        sopt, dopt = SparseAdagrad(0.05), optax.adagrad(0.02)
        state = init_state(model, schema, sopt, dopt, seed=0)
        scan_step = make_scan_train_step(model, schema, sopt, dopt, split=split)
        holder = {"state": state}

        def run(c):
            batch = stacked(c)
            t0 = time.perf_counter()
            st, losses = scan_step(holder["state"], *batch)
            np.asarray(losses)
            holder["state"] = st
            return time.perf_counter() - t0

        per_step = _marginal(run, T, 2 * T)
        results[f"train_examples_per_s/{name}"] = B / per_step
        print(f"{name}: {per_step*1e3:.2f} ms/step -> {B/per_step:,.0f} ex/s")


def bench_lookup(results):
    import jax
    import jax.numpy as jnp

    from deepctr_tpu.data import ipinyou_like_schema

    schema = ipinyou_like_schema()
    V, D = schema.padded_vocab_size, 11
    M = 8192 * schema.num_slots
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(V, D)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, V, size=M).astype(np.int32))

    import functools

    def make_run(f):
        @functools.partial(jax.jit, static_argnames=("n",))
        def scan_n(x, n):
            def body(c, _):
                return f(c), None

            out, _ = jax.lax.scan(body, x, None, length=n)
            return out

        def run(c):
            t0 = time.perf_counter()
            o = scan_n(ids, n=c)
            np.asarray(o[:8])
            return time.perf_counter() - t0

        return run

    # lookup: gather M rows then fold back to ids (chained dependency)
    def lookup_once(cur_ids):
        rows = jnp.take(table, cur_ids, axis=0)
        return (cur_ids + rows[:, 0].astype(jnp.int32) * 0) % V

    run = make_run(lookup_once)
    per = _marginal(run, 10, 20)
    results["embedding_lookups_per_s"] = M / per
    print(f"lookup: {per*1e3:.3f} ms/{M} rows -> {M/per:,.0f} lookups/s")

    # scatter-add (the update path's dominant op)
    rows_g = jnp.asarray(rng.normal(size=(M, D)).astype(np.float32))

    def scatter_once(tbl):
        return tbl.at[ids].add(rows_g) * 0.999  # decay keeps values bounded

    @functools.partial(jax.jit, static_argnames=("n",))
    def scan_scatter(tbl, n):
        def body(c, _):
            return scatter_once(c), None

        out, _ = jax.lax.scan(body, tbl, None, length=n)
        return out

    def run_s(c):
        t0 = time.perf_counter()
        o = scan_scatter(table, n=c)
        np.asarray(o[:1])
        return time.perf_counter() - t0

    per = _marginal(run_s, 10, 20)
    results["scatter_add_rows_per_s"] = M / per
    print(f"scatter-add: {per*1e3:.3f} ms/{M} rows -> {M/per:,.0f} rows/s")


def bench_parser(results):
    from deepctr_tpu.data import ipinyou_like_schema, synthetic
    from deepctr_tpu.data import native, parser

    schema = ipinyou_like_schema()
    ds = synthetic.generate(schema, num_examples=100_000, k=2, seed=9)
    path = os.path.join(_TMP, "bench_parse.yx")
    synthetic.write_yx_file(ds, path)
    size_mb = os.path.getsize(path) / 1e6
    with open(path, "rb") as f:
        data = f.read()

    t0 = time.perf_counter()
    native.parse_yx_bytes(data, schema)
    t_native = time.perf_counter() - t0
    results["parser_native_mb_per_s"] = size_mb / t_native

    t0 = time.perf_counter()
    parser.parse_yx_lines(data.splitlines(), schema)
    t_py = time.perf_counter() - t0
    results["parser_python_mb_per_s"] = size_mb / t_py
    print(
        f"parser: native {size_mb/t_native:.0f} MB/s, python {size_mb/t_py:.1f} "
        f"MB/s ({t_py/t_native:.0f}x)"
    )


def bench_stream(results):
    """Streaming ingestion throughput (host-only): shard files -> shuffled
    batches through StreamSource, vs the raw native-parser floor.  The gap
    to the parser floor is the shuffle-buffer bookkeeping.

    Protocol (round 4): 1.2M rows over 8 shards so the steady-state
    (parse-ahead threads overlapping the reservoir) dominates the
    fill/drain edges; epoch 0 warms the page cache, epochs 1-5 are timed
    and the MEDIAN is reported with a _sigma key (single-epoch text
    timings on the 2-core host swing ~±30% with scheduler luck — same
    median discipline as the training headline)."""
    from deepctr_tpu.data import StreamSource, ipinyou_like_schema, synthetic

    schema = ipinyou_like_schema()
    n_shards, per = 8, 150_000
    ds = synthetic.generate(schema, num_examples=n_shards * per, k=2, seed=9)
    paths = []
    for i in range(n_shards):
        p = os.path.join(_TMP, f"bench_stream_{i}.yx")
        sl = slice(i * per, (i + 1) * per)
        if not os.path.exists(p):
            synthetic.write_yx_file(
                synthetic.SyntheticDataset(schema, ds.ids[sl], ds.labels[sl],
                                           ds.bayes_logits[sl]), p)
        paths.append(p)
    size_mb = sum(os.path.getsize(p) for p in paths) / 1e6

    def epoch_rate(paths, epoch):
        src = StreamSource(paths=paths, schema=schema, batch_size=8192,
                           buffer_rows=1 << 18, seed=0)
        t0 = time.perf_counter()
        rows = sum(b.ids.shape[0] for b in src.batches(epoch))
        return rows / (time.perf_counter() - t0)

    epoch_rate(paths, 0)  # page-cache warmup
    rates = [epoch_rate(paths, e) for e in range(1, 6)]
    rate = float(np.median(rates))
    results["stream_rows_per_s"] = rate
    results["stream_rows_per_s_sigma"] = float(np.std(rates))
    results["stream_mb_per_s"] = rate * size_mb / (n_shards * per)
    print(f"stream: median {rate:,.0f} rows/s σ {np.std(rates):,.0f} "
          f"({results['stream_mb_per_s']:.0f} MB/s text; "
          f"{', '.join(f'{r/1e6:.2f}M' for r in sorted(rates))})")

    # npz cache shards (multi-epoch fast lane: parse once, stream packed)
    from deepctr_tpu.data.cache import cache_text_file

    npz_paths = [cache_text_file(p, schema) for p in paths]
    epoch_rate(npz_paths, 0)
    nrates = [epoch_rate(npz_paths, e) for e in range(1, 6)]
    results["stream_npz_rows_per_s"] = float(np.median(nrates))
    results["stream_npz_rows_per_s_sigma"] = float(np.std(nrates))
    print(f"stream npz: median {results['stream_npz_rows_per_s']:,.0f} "
          f"rows/s σ {np.std(nrates):,.0f}")


def bench_criteo_stream(results):
    """Criteo-format streaming throughput, both lanes (VERDICT r4 Missing
    #4 support): the stretch contract is a Criteo-scale hash space
    (BASELINE.json:11) and its production path is TSV -> native
    criteo_parse -> hash trick -> stream.  Same protocol as bench_stream
    (median of 5 steady-state epochs, sigma reported)."""
    from deepctr_tpu.data import StreamSource
    from deepctr_tpu.data.criteo import criteo_schema, write_synth_criteo_file

    schema = criteo_schema()
    n_shards, per = 8, 100_000
    paths = []
    for i in range(n_shards):
        p = os.path.join(_TMP, f"bench_criteo_{i}.tsv")
        if not os.path.exists(p):
            write_synth_criteo_file(p, per, schema=schema, seed=100 + i)
        paths.append(p)
    size_mb = sum(os.path.getsize(p) for p in paths) / 1e6

    def epoch_rate(pp, epoch, fmt):
        src = StreamSource(paths=pp, schema=schema, batch_size=8192,
                           fmt=fmt, buffer_rows=1 << 18, seed=0)
        t0 = time.perf_counter()
        rows = sum(b.ids.shape[0] for b in src.batches(epoch))
        return rows / (time.perf_counter() - t0)

    epoch_rate(paths, 0, "criteo")  # page-cache warmup
    rates = [epoch_rate(paths, e, "criteo") for e in range(1, 6)]
    results["criteo_stream_rows_per_s"] = float(np.median(rates))
    results["criteo_stream_rows_per_s_sigma"] = float(np.std(rates))
    results["criteo_stream_mb_per_s"] = (
        float(np.median(rates)) * size_mb / (n_shards * per))
    print(f"criteo stream: median {np.median(rates):,.0f} rows/s "
          f"σ {np.std(rates):,.0f} "
          f"({results['criteo_stream_mb_per_s']:.0f} MB/s text)")

    from deepctr_tpu.data.cache import cache_text_file

    npz_paths = [cache_text_file(p, schema, fmt="criteo") for p in paths]
    epoch_rate(npz_paths, 0, "criteo")
    nrates = [epoch_rate(npz_paths, e, "criteo") for e in range(1, 6)]
    results["criteo_stream_npz_rows_per_s"] = float(np.median(nrates))
    results["criteo_stream_npz_rows_per_s_sigma"] = float(np.std(nrates))
    print(f"criteo stream npz: median {np.median(nrates):,.0f} rows/s "
          f"σ {np.std(nrates):,.0f}")


def bench_parser_scaling(results):
    """1-vs-2 parser-thread scaling on THIS host (VERDICT r4 Weak #2): the
    text lane's thread-per-file design claims multi-core scaling; this
    measures the slope that exists here.  Two equal shards are parsed
    back-to-back on one thread, then concurrently on two (the C++ parser
    releases the GIL), median of 5."""
    import threading

    from deepctr_tpu.data import ipinyou_like_schema, native, synthetic

    schema = ipinyou_like_schema()
    per = 300_000
    paths = []
    for i in range(2):
        p = os.path.join(_TMP, f"bench_pscale_{i}.yx")
        if not os.path.exists(p):
            ds = synthetic.generate(schema, num_examples=per, k=2,
                                    seed=40 + i)
            synthetic.write_yx_file(ds, p)
        paths.append(p)
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    native.parse_yx_bytes(blobs[0], schema)  # build/warm the library

    def serial():
        t0 = time.perf_counter()
        for b in blobs:
            native.parse_yx_bytes(b, schema)
        return time.perf_counter() - t0

    def parallel2():
        ts = [threading.Thread(target=native.parse_yx_bytes,
                               args=(b, schema)) for b in blobs]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return time.perf_counter() - t0

    s = [serial() for _ in range(5)]
    p2 = [parallel2() for _ in range(5)]
    results["parser_2thread_speedup"] = float(np.median(s) / np.median(p2))
    print(f"parser thread scaling: serial {np.median(s):.2f}s, "
          f"2-thread {np.median(p2):.2f}s -> "
          f"speedup {results['parser_2thread_speedup']:.2f}x "
          f"(2-CPU host; ideal 2.0)")


def bench_serving_quality(results):
    """Full-vocab serving quality at the parity standard (VERDICT r4 Weak
    #4): train the headline FNN briefly on planted-teacher data, then score
    a held-out set with the f32 / bf16 / int8 Scorer and record each mode's
    AUC.  The int8 word-packed mode is the shipped fastest serving mode;
    its |ΔAUC| vs f32 must sit within the ±0.002 parity band
    (gated in tests/test_artifacts.py via the keys written here)."""
    import jax
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.serving import Scorer
    from deepctr_tpu.train import fit
    from deepctr_tpu.utils.metrics import exact_auc

    schema = ipinyou_full_schema()
    ds = synthetic.generate(schema, num_examples=600_000, k=4, seed=21)
    n = len(ds.labels)
    tr, te = slice(0, n - 100_000), slice(n - 100_000, n)
    model = make_fnn(schema, k=10,
                     mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    res = fit(model, schema, ds.ids[tr], ds.labels[tr], ds.ids[te],
              ds.labels[te], sparse_opt=SparseAdagrad(0.05),
              dense_opt=optax.adagrad(0.02), batch_size=8192, epochs=2,
              seed=0, early_stop_patience=99)
    table = np.asarray(res.state.table, np.float32)
    dense = jax.tree_util.tree_map(np.asarray, res.state.dense)
    for mode in (None, "bf16", "int8"):
        scorer = Scorer(model=model, schema=schema, table=table, dense=dense,
                        batch_size=8192, quantize=mode)
        scores = scorer.logits(ds.ids[te])
        auc = exact_auc(ds.labels[te], np.asarray(scores))
        results[f"serving_auc/{mode or 'f32'}"] = float(auc)
        print(f"serving quality {mode or 'f32'}: AUC {auc:.4f} "
              f"(train best {res.best_auc:.4f})")
    for mode in ("bf16", "int8"):
        d = results[f"serving_auc/{mode}"] - results["serving_auc/f32"]
        results[f"serving_auc_delta/{mode}"] = float(d)
        print(f"  Δ{mode} = {d:+.4f} (band ±0.002)")


def bench_headline_repeats(results, reps: int = 5):
    """Settle the training headline with the serving-grade protocol
    (VERDICT r3 Weak #2): N interleaved single-process repeats of the three
    storage configs (f32 / bf16 table / bf16 table + bf16 scratch), each a
    marginal T-vs-2T scan measurement, reported as median ± σ.  The
    production config in bench.py is whichever bf16 variant's median wins
    by more than the LARGER of the two σ; otherwise the simpler bf16-table
    config is kept."""
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_full_schema()
    B, T = 8192, 8
    ds = synthetic.generate(schema, num_examples=B * 2 * T, k=2, seed=5)
    model = make_fnn(schema, k=10,
                     mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    split = make_split_plan(schema)
    configs = {
        "f32": ("f32", "f32"),
        "bf16table": ("bf16", "f32"),
        "bf16table_bf16scratch": ("bf16", "bf16"),
    }
    setups = {}
    for name, (td, sd) in configs.items():
        sopt = SparseAdagrad(0.05, scratch_dtype=sd)
        dopt = optax.adagrad(0.02)
        setups[name] = {
            "state": init_state(model, schema, sopt, dopt, seed=0,
                                table_dtype=td),
            "step": make_scan_train_step(model, schema, sopt, dopt,
                                         split=split),
        }

    def stacked(c):
        out = (
            jnp.asarray(ds.ids[: c * B]).reshape(c, B, -1),
            jnp.asarray(ds.labels[: c * B]).reshape(c, B),
            jnp.ones((c, B), jnp.float32),
        )
        float(out[0].sum())
        return out

    def one_measurement(su):
        def run(c):
            batch = stacked(c)
            t0 = time.perf_counter()
            st, losses = su["step"](su["state"], *batch)
            np.asarray(losses)
            su["state"] = st
            return time.perf_counter() - t0

        return _marginal(run, T, 2 * T)

    for su in setups.values():  # compile both scan lengths up front
        one_measurement(su)
    samples = {name: [] for name in configs}
    for r in range(reps):  # interleave configs within one process
        for name, su in setups.items():
            samples[name].append(B / one_measurement(su))
    for name, vals in samples.items():
        med = float(np.median(vals))
        sig = float(np.std(vals))
        results[f"headline_median/{name}"] = med
        results[f"headline_sigma/{name}"] = sig
        print(f"{name}: median {med:,.0f} ex/s  σ {sig:,.0f}  "
              f"({', '.join(f'{v/1e6:.2f}M' for v in sorted(vals))})")
    a = results["headline_median/bf16table"]
    b = results["headline_median/bf16table_bf16scratch"]
    sig = max(results["headline_sigma/bf16table"],
              results["headline_sigma/bf16table_bf16scratch"])
    verdict = ("bf16table_bf16scratch" if b - a > sig else "bf16table")
    results["headline_production_config"] = verdict
    print(f"scratch-knob verdict: Δ={b-a:,.0f} vs σ={sig:,.0f} -> {verdict}")


def bench_stream_train(results):
    """END-TO-END training while streaming from npz cache shards, at the
    headline configuration (full-vocab FNN, jnp tower, bf16 table, B=8192,
    scan_steps=8) — the VERDICT r3 Missing #3 number: does the host pipeline
    feed the chip at device rate once the data no longer fits in RAM?

    Protocol: epoch 0 warms compile + page cache; epoch 1 is timed WALL
    CLOCK end to end (parse threads + shuffle reservoir + H2D staging on the
    DevicePrefetcher thread + device compute).  Unlike the in-RAM headline
    this includes every host cost, so quote it next to `h2d_*` below when
    attributing any gap."""
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import StreamSource, ipinyou_full_schema, synthetic
    from deepctr_tpu.data.cache import write_cache
    from deepctr_tpu.data.pipeline import DevicePrefetcher
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_full_schema()
    B, T = 8192, 8
    n_shards, rows_per_shard = 8, 131072  # ~1.05M rows/epoch
    paths = []
    for i in range(n_shards):
        p = os.path.join(_TMP, f"bench_streamtrain_{i}.npz")
        if not os.path.exists(p):
            ds = synthetic.generate(schema, num_examples=rows_per_shard, k=2,
                                    seed=100 + i)
            write_cache(p, ds.ids, ds.labels, schema)
        paths.append(p)

    model = make_fnn(schema, k=10,
                     mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    sopt = SparseAdagrad(0.05, scratch_dtype="bf16")
    dopt = optax.adagrad(0.02)
    holder = {"state": init_state(model, schema, sopt, dopt, seed=0,
                                  table_dtype="bf16")}
    scan_step = make_scan_train_step(
        model, schema, sopt, dopt, split=make_split_plan(schema)
    )

    def epoch(ep):
        src = StreamSource(paths=paths, schema=schema, batch_size=B,
                           buffer_rows=1 << 18, seed=ep)
        it = DevicePrefetcher(src.scan_chunks(ep, T), depth=2)
        rows, losses = 0, None
        t0 = time.perf_counter()
        for nb, (ids_t, y_t, w_t) in it:
            holder["state"], losses = scan_step(
                holder["state"], ids_t, y_t, w_t
            )
            rows += nb * B
        np.asarray(losses)  # host fetch ends the timed epoch
        return rows, time.perf_counter() - t0

    epoch(0)
    rows, dt = epoch(1)
    results["train_stream_examples_per_s"] = rows / dt
    print(f"train-while-streaming: {rows} rows in {dt:.2f}s -> "
          f"{rows/dt:,.0f} ex/s")


def bench_dispatch_wall(results):
    """The WALL-CLOCK cost of scan dispatches at the headline config with
    inputs already device-resident (no host pipeline, no H2D).  The gap
    between this and the marginal-protocol headline is the per-dispatch
    overhead that binds ANY host-driven loop (streaming or in-RAM alike),
    not a property of the host pipeline."""
    import jax
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_full_schema()
    B, T = 8192, 8
    model = make_fnn(schema, k=10,
                     mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    sopt = SparseAdagrad(0.05)
    dopt = optax.adagrad(0.02)
    state = init_state(model, schema, sopt, dopt, seed=0, table_dtype="bf16")
    scan_step = make_scan_train_step(model, schema, sopt, dopt,
                                     split=make_split_plan(schema))
    ds = synthetic.generate(schema, num_examples=T * B, k=2, seed=5)
    chunk = (jnp.asarray(ds.ids).reshape(T, B, -1),
             jnp.asarray(ds.labels).reshape(T, B),
             jnp.ones((T, B), jnp.float32))
    float(chunk[0].sum())
    state, losses = scan_step(state, *chunk)  # compile + warm
    np.asarray(losses)
    N = 8
    t0 = time.perf_counter()
    for _ in range(N):
        state, losses = scan_step(state, *chunk)
    np.asarray(losses)
    dt = time.perf_counter() - t0
    results["dispatch_wall_ms_per_scan8"] = dt / N * 1e3
    results["train_inram_wall_examples_per_s"] = N * T * B / dt
    print(f"pre-staged wall: {N} scan-8 dispatches in {dt:.1f}s -> "
          f"{dt/N:.2f}s/dispatch, {N*T*B/dt:,.0f} ex/s wall")


def bench_h2d(results):
    """Host->device transfer floor of this machine.

    The in-RAM headline stages batches on device before the clock starts;
    a streaming run cannot.  This measures the sustained device_put rate of
    scan-chunk-shaped arrays (ids int32[8,8192,S] + labels/weights f32),
    giving the hard ceiling `h2d_examples_per_s_ceiling` any host-fed
    training loop obeys on this machine."""
    import jax
    import jax.numpy as jnp

    from deepctr_tpu.data import ipinyou_full_schema

    schema = ipinyou_full_schema()
    B, T, S = 8192, 8, schema.num_slots
    rng = np.random.default_rng(0)
    n_bufs = 8
    bufs = [
        (
            rng.integers(0, schema.padded_vocab_size,
                         size=(T, B, S)).astype(np.int32),
            rng.random((T, B), dtype=np.float32),
            np.ones((T, B), np.float32),
        )
        for _ in range(n_bufs)
    ]
    bytes_per_chunk = sum(a.nbytes for a in bufs[0])

    def run(reps):
        t0 = time.perf_counter()
        out = None
        for i in range(reps):
            out = jax.device_put(bufs[i % n_bufs])
        jax.block_until_ready(out)
        np.asarray(out[1][:1, :8])  # host fetch barrier
        return time.perf_counter() - t0

    run(4)
    per = _marginal(run, 8, 16)
    results["h2d_mb_per_s"] = bytes_per_chunk / per / 1e6
    results["h2d_examples_per_s_ceiling"] = T * B / per
    print(f"h2d: {bytes_per_chunk/1e6:.1f} MB/chunk, {per*1e3:.2f} ms -> "
          f"{bytes_per_chunk/per/1e6:,.0f} MB/s, ceiling "
          f"{T*B/per:,.0f} ex/s")


def bench_serving(results):
    """Scorer (inference) throughput at full-iPinYou vocab per quant mode.

    Device-only number: the jitted forward inside one lax.scan (marginal
    T vs 2T), chained through a non-foldable select so XLA cannot DCE or
    overlap iterations.  The reference's pred_fn analogue (serving.py).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.serving import Scorer

    schema = ipinyou_full_schema()
    B = 8192
    ds = synthetic.generate(schema, num_examples=B, k=2, seed=11)
    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    params = model.init_params(jax.random.PRNGKey(0), schema)
    ids0 = jnp.asarray(ds.ids)

    for mode in (None, "bf16", "int8"):
        scorer = Scorer(model=model, schema=schema,
                        table=np.asarray(params["table"]),
                        dense=params["dense"], batch_size=B, quantize=mode)
        fwd, table, dense = scorer._fwd, scorer._table, scorer._dense

        @functools.partial(jax.jit, static_argnames=("n",))
        def scan_n(ids, n, fwd=fwd, table=table, dense=dense):
            def body(c, _):
                logits = fwd(table, dense, c)
                # runtime-value select: keeps a true data dependency between
                # iterations (a `* 0` chain would constant-fold away)
                c2 = jnp.where(logits[0] > jnp.float32(1e30), c + 1, c)
                return c2, None

            out, _ = jax.lax.scan(body, ids, None, length=n)
            return out

        def run(c):
            t0 = time.perf_counter()
            o = scan_n(ids0, n=c)
            np.asarray(o[:1])
            return time.perf_counter() - t0

        per = _marginal(run, 10, 20)
        key = f"serving_examples_per_s/{mode or 'f32'}"
        results[key] = B / per
        print(f"serving {mode or 'f32'}: {per*1e3:.3f} ms/batch -> "
              f"{B/per:,.0f} ex/s")


def bench_full_schema(results, batch_sizes=(8192,)):
    """Headline model at full-iPinYou vocabulary (~0.94M features).

    ``batch_sizes`` beyond 8192 form the batch-scaling study: the sparse
    floors (scatter/gather) scale per-row while the full-table Adagrad
    elementwise and dispatch overheads are fixed per step, so larger batches
    amortise them.
    """
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_full_schema()
    for B in batch_sizes:
        _bench_full_schema_one(results, schema, B)


def bench_batch_bf16(results):
    """Peak-throughput probe: biggest batch x the bf16 storage knobs."""
    from deepctr_tpu.data import ipinyou_full_schema

    _bench_full_schema_one(results, ipinyou_full_schema(), 32768,
                           table_dtype="bf16", scratch_dtype="bf16")


def bench_batch_bf16_median(results, reps: int = 5):
    """The peak-throughput CLAIM under the median protocol (VERDICT r4
    stretch #9): the B=32k bf16 point was a single run in a file whose own
    round-4 section proves single runs mislead.  5 marginal T-vs-2T
    measurements in one process, median + sigma recorded."""
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_full_schema()
    B, T = 32768, 8
    ds = synthetic.generate(schema, num_examples=B * 2 * T, k=2, seed=5)
    model = make_fnn(schema, k=10,
                     mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    sopt = SparseAdagrad(0.05, scratch_dtype="bf16")
    dopt = optax.adagrad(0.02)
    holder = {"state": init_state(model, schema, sopt, dopt, seed=0,
                                  table_dtype="bf16")}
    scan_step = make_scan_train_step(model, schema, sopt, dopt,
                                     split=make_split_plan(schema))

    def run(c):
        batch = (
            jnp.asarray(ds.ids[: c * B]).reshape(c, B, -1),
            jnp.asarray(ds.labels[: c * B]).reshape(c, B),
            jnp.ones((c, B), jnp.float32),
        )
        float(batch[0].sum())
        t0 = time.perf_counter()
        st, losses = scan_step(holder["state"], *batch)
        np.asarray(losses)
        holder["state"] = st
        return time.perf_counter() - t0

    _marginal(run, T, 2 * T)  # compile both lengths
    vals = [B / _marginal(run, T, 2 * T) for _ in range(reps)]
    key = "peak_median/fnn_full_vocab_b32768_bf16"
    results[key] = float(np.median(vals))
    results["peak_sigma/fnn_full_vocab_b32768_bf16"] = float(np.std(vals))
    print(f"peak b32k bf16: median {np.median(vals):,.0f} ex/s "
          f"σ {np.std(vals):,.0f} "
          f"({', '.join(f'{v/1e6:.2f}M' for v in sorted(vals))})")


def bench_full_bf16(results):
    """Headline config with the bf16 storage knobs (math stays f32):
    table_dtype=bf16 halves the gather + full-table elementwise streams;
    adding scratch_dtype=bf16 also halves the scatter's write stream."""
    from deepctr_tpu.data import ipinyou_full_schema

    schema = ipinyou_full_schema()
    _bench_full_schema_one(results, schema, 8192, table_dtype="bf16")
    _bench_full_schema_one(results, schema, 8192, table_dtype="bf16",
                           scratch_dtype="bf16")


def _bench_full_schema_one(results, schema, B, table_dtype="f32",
                           scratch_dtype="f32"):
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    T = 8
    ds = synthetic.generate(schema, num_examples=B * 2 * T, k=2, seed=5)
    # the headline configuration's model (see bench.py)
    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5))
    sopt = SparseAdagrad(0.05, scratch_dtype=scratch_dtype)
    dopt = optax.adagrad(0.02)
    from deepctr_tpu.ops.split_embed import make_split_plan

    holder = {"state": init_state(model, schema, sopt, dopt, seed=0,
                                  table_dtype=table_dtype)}
    scan_step = make_scan_train_step(
        model, schema, sopt, dopt, split=make_split_plan(schema)
    )

    def run(c):
        sel = slice(0, c * B)
        batch = (
            jnp.asarray(ds.ids[sel]).reshape(c, B, -1),
            jnp.asarray(ds.labels[sel]).reshape(c, B),
            jnp.ones((c, B), jnp.float32),
        )
        float(batch[0].sum())
        t0 = time.perf_counter()
        st, losses = scan_step(holder["state"], *batch)
        np.asarray(losses)
        holder["state"] = st
        return time.perf_counter() - t0

    per_step = _marginal(run, T, 2 * T)
    suffix = "" if table_dtype == "f32" else f"_{table_dtype}table"
    if scratch_dtype != "f32":
        suffix += f"_{scratch_dtype}scratch"
    key = (f"train_examples_per_s/fnn_full_vocab{suffix}" if B == 8192
           else f"train_examples_per_s/fnn_full_vocab_b{B}{suffix}")
    results[key] = B / per_step
    print(f"fnn@full-vocab B={B} table={table_dtype}: "
          f"{per_step*1e3:.2f} ms/step -> {B/per_step:,.0f} ex/s")


def main():
    import argparse

    import jax

    from deepctr_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--sections", default="parser,models,full,lookup,serving,stream",
        help="comma list: parser,models,full,lookup,serving,stream,"
        "criteostream,parserscale,servingquality,streamtrain,h2d,batch "
        "(run big sections in separate invocations; results accumulate in "
        "the --out file)",
    )
    ap.add_argument("--out", default=os.path.join(_TMP,
                                                  "deepctr_bench_suite.json"))
    args = ap.parse_args()
    sections = set(args.sections.split(","))

    acc_path = args.out
    results = {}
    if os.path.exists(acc_path):
        with open(acc_path) as f:
            results = json.load(f)
    dev = jax.devices()[0]
    results["device"] = f"{dev.platform}:{dev.device_kind} x{len(jax.devices())}"
    if "parser" in sections:
        bench_parser(results)
    if "models" in sections:
        bench_models(results)
    if "full" in sections:
        bench_full_schema(results)
    if "fullbf16" in sections:
        bench_full_bf16(results)
    if "batch" in sections:
        bench_full_schema(results, batch_sizes=(16384, 32768))
    if "batchbf16" in sections:
        bench_batch_bf16(results)
    if "batchbf16med" in sections:
        bench_batch_bf16_median(results)
    if "lookup" in sections:
        bench_lookup(results)
    if "serving" in sections:
        bench_serving(results)
    if "stream" in sections:
        bench_stream(results)
    if "criteostream" in sections:
        bench_criteo_stream(results)
    if "parserscale" in sections:
        bench_parser_scaling(results)
    if "servingquality" in sections:
        bench_serving_quality(results)
    if "streamtrain" in sections:
        bench_stream_train(results)
    if "h2d" in sections:
        bench_h2d(results)
    if "dispatch" in sections:
        bench_dispatch_wall(results)
    if "headline" in sections:
        bench_headline_repeats(results)
    os.makedirs(os.path.dirname(os.path.abspath(acc_path)), exist_ok=True)
    with open(acc_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {acc_path}")
    print(json.dumps({k: (round(v, 1) if isinstance(v, (int, float)) else v)
                      for k, v in results.items()}))


if __name__ == "__main__":
    main()
