"""Headline benchmark: FNN training examples/s/chip on iPinYou-shaped data.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Exits non-zero, printing no result, when JAX's backend is not a GPU.

Baseline protocol (SURVEY.md §0/§6, BASELINE.md): the reference repo
publishes no perf numbers and its mount was empty, so the baseline is
MEASURED by running the NumPy-faithful reproduction of the reference's
training procedure (deepctr_tpu/reference_impl) on this host — the same
model family, the reference's host-driven per-batch design.  The measured
number is cached in BASELINE_MEASURED.json so repeat runs are stable.
``vs_baseline`` = our GPU examples/s / reference-reproduction examples/s.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "BASELINE_MEASURED.json")

BATCH = 8192
K = 10
HIDDEN = (200, 300, 100)
WARMUP_STEPS = 6
MEASURE_STEPS = 40
N_EXAMPLES = 2 * MEASURE_STEPS * BATCH  # warmup scan + measured scan


def measure_baseline(schema, ids, labels) -> float:
    """Reference-reproduction FNN throughput (examples/s) on this host."""
    if os.path.exists(BASELINE_CACHE):
        try:
            with open(BASELINE_CACHE) as f:
                cached = json.load(f)
            if cached.get("config") == _config_key():
                return float(cached["fnn_examples_per_s"])
        except (OSError, ValueError, KeyError) as e:
            print(f"ignoring unreadable {BASELINE_CACHE}: {e}", file=sys.stderr)
    from deepctr_tpu.reference_impl import NumpyFNN, train_numpy_model

    ref = NumpyFNN(schema, k=K, hidden=HIDDEN, lr=0.01, seed=0)
    # warm the caches with one batch, then measure for a bounded wall time
    ref.train_batch(ids[:BATCH], labels[:BATCH])
    seen, secs = train_numpy_model(
        ref, ids, labels, batch_size=BATCH, epochs=10**6, seed=1, shuffle=False,
        max_seconds=20.0,
    )
    val = seen / secs
    with open(BASELINE_CACHE, "w") as f:
        json.dump(
            {
                "config": _config_key(),
                "fnn_examples_per_s": val,
                "note": "NumPy reproduction of the reference's FNN trainer "
                "(reference mount empty; see SURVEY.md §0) measured on this host",
            },
            f,
            indent=2,
        )
    return val


def _config_key():
    return {"batch": BATCH, "k": K, "hidden": list(HIDDEN), "model": "fnn", "schema": "ipinyou_full"}


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    from deepctr_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import init_state, make_train_step

    from deepctr_tpu.train.step import make_scan_train_step

    # full-iPinYou-scale vocabulary (~0.94M features): the headline
    # number must reflect production-representative table sizes
    schema = ipinyou_full_schema()
    ds = synthetic.generate(schema, num_examples=N_EXAMPLES, k=4, seed=3)

    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.5))
    # bf16 table storage, f32 math/accumulators/scratch: halves the device
    # memory streams of the gather and the full-table Adagrad elementwise;
    # tests/test_train.py gates the bf16 table's training AUC
    sopt = SparseAdagrad(0.05)
    dopt = optax.adagrad(0.02)
    state = init_state(model, schema, sopt, dopt, seed=0, table_dtype="bf16")

    # one jitted lax.scan over all measured steps, so host dispatch is not
    # part of the per-step cost
    from deepctr_tpu.ops.split_embed import make_split_plan

    scan_step = make_scan_train_step(
        model, schema, sopt, dopt, split=make_split_plan(schema)
    )

    def stack(start, count):
        sel = slice(start * BATCH, (start + count) * BATCH)
        return (
            jnp.asarray(ds.ids[sel]).reshape(count, BATCH, -1),
            jnp.asarray(ds.labels[sel]).reshape(count, BATCH),
            jnp.ones((count, BATCH), jnp.float32),
        )

    # Timing protocol: time a T-step and a 2T-step scan, each ending in a
    # host fetch, and report the MARGINAL per-step cost (the difference
    # cancels dispatch and fetch overhead).  Whether plain
    # block_until_ready timing gives the same number on the GPU is still to
    # be checked against a profiler trace.
    def timed(count, start):
        nonlocal state
        batch = stack(start, count)
        # the host-to-device copy finishes before the clock starts
        float(batch[0].sum())
        t0 = time.perf_counter()
        st2, losses = scan_step(state, *batch)
        losses_np = np.asarray(losses)
        assert np.isfinite(losses_np).all()
        state = st2
        return time.perf_counter() - t0

    timed(MEASURE_STEPS, 0)                     # warmup/compile T
    timed(2 * MEASURE_STEPS, 0)                 # warmup/compile 2T
    # median of 5 interleaved T/2T marginal pairs in one process
    reps = []
    for _ in range(5):
        t_short = timed(MEASURE_STEPS, 0)
        t_long = timed(2 * MEASURE_STEPS, 0)
        reps.append(MEASURE_STEPS * BATCH / max(t_long - t_short, 1e-9))
    value = float(np.median(reps))

    baseline = measure_baseline(schema, ds.ids, ds.labels)
    print(
        json.dumps(
            {
                "metric": "fnn_train_examples_per_s_per_chip",
                "value": round(value, 1),
                "unit": "examples/s",
                "vs_baseline": round(value / baseline, 3),
                "protocol": "median_of_5_interleaved_marginal_pairs",
                "sigma": round(float(np.std(reps)), 1),
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
