"""Where the headline training step's device time goes: the dense tower's
share, the op groups around it, and the plain-jnp FM step.

Runs bench.py's configuration (full-vocab FNN 176->200->300->100->1,
dropout 0.5, B=8192, bf16 table, Adagrad, scans of 8 steps) on the GPU and

- times scan dispatches with ``block_until_ready`` (host clock), both as
  XLA compiles the step by default and with CUDA graphs off;
- traces a few dispatches of the CUDA-graphs-off executable with
  ``jax.profiler`` and groups each device op by its HLO metadata op_name
  (``op_group``): the ``onehot_lookup`` and ``dense_tower`` name scopes,
  forward and backward, then converts, patch updates
  (dynamic_update_slice), scatter, sort, gather and the rest.
  Busy time is the union of the op intervals on the GPU's stream lines;
- times a tower-only forward+backward scan (same widths, same dropout) and
  the FM (k=10) training scan at the same vocabulary and batch.

XLA runs the scan body as one CUDA graph ("command_buffer" in the trace),
which hides the ops inside it, so the traced executable is compiled with
``xla_gpu_enable_command_buffer`` empty whatever ``XLA_FLAGS`` says; the
reduction fails if command-buffer events still hold the op time or if no
op falls in the ``dense_tower`` scope.

Prints one JSON object (also written to --out) with the card's name and
power limit.  Exits non-zero when JAX's backend is not a GPU.  This is a
reproduction of the bring-up's tower-share numbers, not the benchmark.

Run: python tools/tower_share.py [--out DIR/tower_share.json]
     (--out also keeps the trace and the compiled HLO in DIR)
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

B, T, HIDDEN = 8192, 8, (200, 300, 100)
REPS = 20              # timed dispatches per median
TRACED_DISPATCHES = 3
TOWER_SCOPE = "dense_tower"
# name scopes split forward/backward (backward ops carry "transpose(" in
# their op_name), then primitives; the first match wins
SCOPES = ("onehot_lookup", TOWER_SCOPE)
PRIMITIVES = ("convert_element_type", "dynamic_update_slice", "scatter",
              "sort", "gather")
NO_COMMAND_BUFFER = {"xla_gpu_enable_command_buffer": ""}
# command-buffer events above this share of op time hide the per-op split
MAX_COMMAND_BUFFER_SHARE = 0.01


def _time_dispatches(fn, state, args):
    """Median seconds per dispatch of ``state = fn(state, *args)[0]``."""
    import jax

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        state, out = fn(state, *args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), state


def op_names_from_hlo(hlo_text: str) -> dict[str, str]:
    """instruction name -> metadata op_name, from compiled HLO text."""
    pat = re.compile(
        r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?metadata=\{[^}]*op_name=\"([^\"]*)\""
    )
    out = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def op_group(op_name: str | None) -> str:
    """The group of one HLO op, from its metadata op_name."""
    if not op_name:
        return "unattributed"
    for scope in SCOPES:
        if scope in op_name:
            return f"{scope}_{'bwd' if 'transpose(' in op_name else 'fwd'}"
    for prim in PRIMITIVES:
        if prim in op_name:
            return prim
    return "other"


def summarize(events, op_names: dict[str, str], steps: int) -> dict:
    """Busy time, idle share and op groups of ``[(start_ns, dur_ns, hlo
    instruction), ...]`` from ``steps`` traced training steps.

    Raises when command-buffer events hold more than
    ``MAX_COMMAND_BUFFER_SHARE`` of the op time, or when no op time falls
    in the ``dense_tower`` scope: either way the per-op split is blind.
    """
    if not events:
        raise RuntimeError("no GPU stream events in the trace")
    events = sorted(events)
    busy, end = 0.0, -1.0
    for start, dur, _ in events:
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    window = max(s + d for s, d, _ in events) - events[0][0]
    by_op: dict[str, float] = {}
    for _, dur, hlo in events:
        by_op[hlo] = by_op.get(hlo, 0.0) + dur
    total = sum(by_op.values())
    graphs = sum(d for op, d in by_op.items() if "command_buffer" in op)
    if graphs > MAX_COMMAND_BUFFER_SHARE * total:
        raise RuntimeError(
            f"command-buffer events hold {graphs / total:.1%} of the op "
            f"time: the trace hides the ops inside CUDA graphs")
    groups: dict[str, float] = {}
    for op, d in by_op.items():
        g = op_group(op_names.get(op))
        groups[g] = groups.get(g, 0.0) + d
    tower = groups.get(f"{TOWER_SCOPE}_fwd", 0.0) + groups.get(
        f"{TOWER_SCOPE}_bwd", 0.0)
    if tower <= 0:
        raise RuntimeError(f"no traced op time in the {TOWER_SCOPE!r} scope")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:25]
    return {
        "device_busy_ms_per_step": busy / steps / 1e6,
        "op_ms_per_step": total / steps / 1e6,
        "device_idle_share": 1 - busy / window,
        "tower_ms_per_step": tower / steps / 1e6,
        "tower_share_of_op_time": tower / total,
        "groups": {
            g: {"us_per_step": d / steps / 1e3, "share_of_op_time": d / total}
            for g, d in sorted(groups.items(), key=lambda kv: -kv[1])
        },
        "top_ops": [[op, d / steps / 1e3, op_names.get(op, "?")]
                    for op, d in top],
    }


def gpu_stream_events(xplane_path: str):
    """``[(start_ns, dur_ns, hlo instruction), ...]`` on the GPU's stream
    lines of one ``jax.profiler`` trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    return [
        (ev.start_ns, ev.duration_ns,
         str(dict(ev.stats).get("hlo_op", ev.name)).lstrip("%"))
        for p in pd.planes if "GPU" in p.name
        for ln in p.lines if ln.name.startswith("Stream")
        for ev in ln.events
    ]


def main():
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit(f"tower_share measures the GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    from deepctr_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_full_schema, synthetic
    from deepctr_tpu.models import FMModel, MlpSpec, make_fnn
    from deepctr_tpu.models.base import apply_mlp, init_mlp
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    res = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "batch": B, "scan_steps": T, "reps": REPS}
    schema = ipinyou_full_schema()
    split = make_split_plan(schema)
    ds = synthetic.generate(schema, num_examples=T * B, k=2, seed=5)
    chunk = (jnp.asarray(ds.ids).reshape(T, B, -1),
             jnp.asarray(ds.labels).reshape(T, B),
             jnp.ones((T, B), jnp.float32))

    def lower_for(model):
        sopt, dopt = SparseAdagrad(0.05), optax.adagrad(0.02)
        state = init_state(model, schema, sopt, dopt, seed=0,
                           table_dtype="bf16")
        step = make_scan_train_step(model, schema, sopt, dopt, split=split)
        return step.lower(state, *chunk), state

    # --- headline FNN step: time as compiled by default, then time and
    # trace the same step with CUDA graphs off
    fnn = make_fnn(schema, k=10, mlp=MlpSpec(hidden=HIDDEN, dropout=0.5))
    lowered, state = lower_for(fnn)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    res["fnn_compile_s"] = time.perf_counter() - t0
    state, _ = compiled(state, *chunk)  # warm
    per_dispatch, state = _time_dispatches(compiled, state, chunk)
    res.update(fnn_step_ms=per_dispatch / T * 1e3,
               fnn_examples_per_s=T * B / per_dispatch)
    traced = lowered.compile(compiler_options=NO_COMMAND_BUFFER)
    state, _ = traced(state, *chunk)
    per_dispatch, state = _time_dispatches(traced, state, chunk)
    res["fnn_step_ms_no_command_buffer"] = per_dispatch / T * 1e3
    hlo = traced.as_text()
    tdir = tempfile.mkdtemp(prefix="tower_trace_")
    with jax.profiler.trace(tdir):
        for _ in range(TRACED_DISPATCHES):
            state, losses = traced(state, *chunk)
        jax.block_until_ready(losses)
    xplane = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                       recursive=True)[0]
    if args.out and os.path.getsize(xplane) < 32 << 20:
        # keep the trace and the HLO it is read against beside the JSON
        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        shutil.copy(xplane, os.path.join(out_dir, "tower_trace.xplane.pb"))
        with open(os.path.join(out_dir, "tower_step.hlo.txt"), "w") as f:
            f.write(hlo)
    res["trace"] = summarize(gpu_stream_events(xplane),
                             op_names_from_hlo(hlo), TRACED_DISPATCHES * T)
    shutil.rmtree(tdir, ignore_errors=True)

    # --- the tower alone: forward + backward with dropout, same widths
    spec = MlpSpec(hidden=HIDDEN, dropout=0.5)
    mlp = init_mlp(jax.random.PRNGKey(0), schema.num_fields * 11, spec)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, schema.num_fields * 11))

    @jax.jit
    def tower_scan(carry, x):
        def body(c, i):
            mlp_, acc = c
            f = lambda m, x_: apply_mlp(  # noqa: E731
                m, x_, spec, train=True,
                rng=jax.random.fold_in(jax.random.PRNGKey(2), i)).sum()
            gm, gx = jax.grad(f, argnums=(0, 1))(mlp_, x)
            mlp_ = jax.tree_util.tree_map(lambda p, g: p - 1e-6 * g, mlp_, gm)
            return (mlp_, acc + gx.sum()), None

        carry, _ = jax.lax.scan(body, carry, jnp.arange(T))
        return carry, carry[1]

    carry = (mlp, jnp.float32(0))
    carry, _ = tower_scan(carry, x)
    per, carry = _time_dispatches(tower_scan, carry, (x,))
    res["tower_only_ms_per_step"] = per / T * 1e3

    # --- the plain-jnp FM step at the same vocabulary and batch
    lowered_fm, state_fm = lower_for(FMModel(k=10))
    compiled_fm = lowered_fm.compile()
    state_fm, _ = compiled_fm(state_fm, *chunk)
    per, state_fm = _time_dispatches(compiled_fm, state_fm, chunk)
    res.update(fm_step_ms=per / T * 1e3, fm_examples_per_s=T * B / per)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    summary = dict(res)
    summary["trace"] = {k: v for k, v in res["trace"].items()
                        if k != "top_ops"}
    summary["trace"]["top_ops"] = res["trace"]["top_ops"][:12]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
