"""Generate SCALING.md: per-step exchange accounting of the sharded step,
validated against the compiled program.

(a) Exact per-step exchange-volume accounting, closed-form in the step's
static shapes (parallel/comm.py — the capacity formula is shared with the
executing step); (b) validation of the accounting against the collective
operand buffers in the compiled StableHLO of the actual step on an 8-device
CPU mesh.  Link times and scaling efficiency are not predicted here: they
come from a measured device trace.

Run: python tools/scaling_report.py          (HLO validation included)
     python tools/scaling_report.py --fast   (skip the HLO section)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the whole report runs on the virtual CPU mesh: force it BEFORE jax
# initialises a backend, or a single accelerator would collapse the
# 8-device mesh and elide every collective from the HLO
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


_WIDTH = {"f32": 4, "i32": 4, "ui32": 4, "bf16": 2, "f16": 2, "i8": 1,
          "i64": 8, "ui64": 8, "f64": 8, "i16": 2, "ui16": 2, "i1": 1}


def collective_bytes(txt: str) -> dict:
    """Per-collective operand-byte totals + op counts from StableHLO text.

    Region-carrying ops (all_reduce) put their ``: (operands) -> results``
    signature on the region-closing line, so each match scans forward to the
    first line containing the arrow; only the operand side (left of ``->``)
    is summed.  Scalar operands (``tensor<f32>``) don't match the shape
    regex and are deliberately excluded on both sides of the comparison
    (loss/weight/drop-counter psums, a few bytes)."""
    import re

    tensor_re = re.compile(r"tensor<([0-9]+(?:x[0-9]+)*)x([a-z][a-z0-9]*)>")
    ops = ("all_to_all", "all_gather", "all_reduce", "reduce_scatter",
           "collective_permute")
    out = {op: 0 for op in ops}
    counts = {op: 0 for op in ops}
    lines = txt.splitlines()
    i = 0
    while i < len(lines):
        hit = next(
            (op for op in ops if f"stablehlo.{op}" in lines[i]), None
        )
        if hit is None:
            i += 1
            continue
        j = i
        while j < len(lines) and "->" not in lines[j]:
            j += 1
        assert j < len(lines), f"no signature after {lines[i]!r}"
        left = lines[j].split("->")[0]
        # the operand signature is the LAST ': (' before the arrow —
        # attribute tensors (replica_groups dense<..> : tensor<1x8xi64>)
        # come earlier on the line and must not be counted
        sig_at = left.rfind(": (")
        if sig_at >= 0:
            left = left[sig_at:]
        got = 0
        for mt in tensor_re.finditer(left):
            dims = [int(x) for x in mt.group(1).split("x")]
            got += int(np.prod(dims)) * _WIDTH[mt.group(2)]
        out[hit] += got
        counts[hit] += 1
        i = j + 1
    out["counts"] = counts
    return out


def hlo_validation(lines):
    """Pin the accounting to the COMPILED program: lower the sharded train
    AND eval steps — without and WITH the split plan — and compare every
    collective's operand buffers in the StableHLO against comm_volume's
    closed forms (all_to_all payloads, small-field all_gathers, small-field
    + dense-tower psums).  (Wall-clock is not a usable validator on the CPU
    mesh: its 8 "devices" share one address space, so a collective is a
    pointer shuffle — measured ~0 marginal cost per MB.)"""
    import optax

    from deepctr_tpu.data import ipinyou_like_schema, synthetic
    from deepctr_tpu.models import FMModel, MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.parallel import (
        comm_volume,
        dense_param_bytes,
        init_sharded_state,
        make_data_mesh,
        make_sharded_eval_step,
        make_sharded_train_step,
        shard_batch_arrays,
    )

    assert len(jax.devices()) >= 8, jax.devices()
    schema = ipinyou_like_schema()
    mesh = make_data_mesh()
    sopt, dopt = SparseAdagrad(0.05), optax.adagrad(0.02)
    B = 8192
    ds = synthetic.generate(schema, num_examples=B, k=2, seed=0)
    ids_d, y_d, w_d = shard_batch_arrays(
        mesh, ds.ids, ds.labels, np.ones(B, np.float32)
    )

    lines.append("\n## Validation against the compiled program "
                 "(8-device mesh)\n")
    lines.append("Every non-scalar collective in the lowered StableHLO of "
                 "the ACTUAL steps, per-device operand bytes, accounted "
                 "(`parallel/comm.py` closed forms) vs compiled.  a2a = the "
                 "three all_to_alls (id route + row fwd + grad bwd); ag = "
                 "small-field subtable all_gathers (operand side, i.e. "
                 "result/N); psum = small-field grad + dense-tower grad "
                 "all_reduce operands (scalar psums excluded on both "
                 "sides):\n")
    lines.append("| step / config | collective | ops | accounted bytes/dev "
                 "| compiled bytes/dev | match |")
    lines.append("|---|---|---|---|---|---|")

    def check(label, txt, want_by_op, want_counts):
        got = collective_bytes(txt)
        for op, want in want_by_op.items():
            g = got[op]
            cnt = got["counts"][op]
            wc = want_counts.get(op)
            ok = g == want and (wc is None or cnt == wc)
            lines.append(
                f"| {label} | {op} | {cnt} | {want:,} | {g:,} | "
                f"{'yes' if ok else f'NO'} |"
            )
            print(f"{label} {op}: accounted {want:,} compiled {g:,} "
                  f"({cnt} ops) -> {'ok' if ok else 'MISMATCH'}")
            assert g == want, (label, op, g, want)
            if wc is not None:
                assert cnt == wc, (label, op, cnt, wc)

    def nonscalar_dense_bytes(model):
        """dense-psum bytes visible to the parser: 0-d leaves lower to
        tensor<f32> which the shape regex excludes on both sides."""
        params = model.init_params(jax.random.PRNGKey(0), schema)
        return sum(
            int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree_util.tree_leaves(params["dense"])
            if getattr(x, "ndim", 0) >= 1
        )

    # ---- no split plan: FM, pure all-to-all path (3 configs) -------------
    model = FMModel(k=10)
    state = init_sharded_state(model, schema, sopt, dopt, mesh, seed=0)
    db_fm = nonscalar_dense_bytes(model)
    for label, cf, dtype, xb in (("train FM no-split cf=2.0 f32", 2.0, "f32", 4),
                                 ("train FM no-split cf=1.0 f32", 1.0, "f32", 4),
                                 ("train FM no-split cf=2.0 bf16", 2.0, "bf16", 2)):
        step = make_sharded_train_step(
            model, schema, sopt, dopt, mesh, capacity_factor=cf,
            exchange_dtype=dtype,
        )
        txt = jax.jit(lambda s, i, y, w: step(s, i, y, w)).lower(
            state, ids_d, y_d, w_d
        ).as_text()
        v = comm_volume(schema, B // 8, 8, cf, split=None,
                        dense_param_bytes=db_fm, exchange_bytes=xb)
        check(label, txt,
              {"all_to_all": v.ids_a2a + v.rows_a2a_fwd + v.rows_a2a_bwd,
               "all_gather": 0,
               "all_reduce": v.dense_psum},
              {"all_to_all": 3, "all_gather": 0})

    # ---- WITH the split plan: FNN tower, small-field ag/psum terms -------
    split = make_split_plan(schema)
    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(64, 32), dropout=0.0))
    state = init_sharded_state(model, schema, sopt, dopt, mesh, seed=0)
    db = nonscalar_dense_bytes(model)
    n_small = len(split.small)
    for label, cf, xb in (("train FNN split cf=2.0 f32", 2.0, 4),
                          ("train FNN split cf=1.25 bf16", 1.25, 2)):
        step = make_sharded_train_step(
            model, schema, sopt, dopt, mesh, capacity_factor=cf,
            split=split, exchange_dtype="bf16" if xb == 2 else "f32",
        )
        txt = jax.jit(lambda s, i, y, w: step(s, i, y, w)).lower(
            state, ids_d, y_d, w_d
        ).as_text()
        v = comm_volume(schema, B // 8, 8, cf, split=split,
                        dense_param_bytes=db, exchange_bytes=xb)
        check(label, txt,
              {"all_to_all": v.ids_a2a + v.rows_a2a_fwd + v.rows_a2a_bwd,
               # compiled all_gather records the operand (= result / N)
               "all_gather": v.small_allgather // 8,
               "all_reduce": v.small_psum + v.dense_psum},
              {"all_to_all": 3, "all_gather": n_small})

    # ---- eval steps: forward-only inventory (2 configs) ------------------
    for label, sp in (("eval FNN split cf=2.0 f32", split),
                      ("eval FNN no-split cf=2.0 f32", None)):
        estep = make_sharded_eval_step(model, schema, mesh,
                                       capacity_factor=2.0, split=sp)
        txt = jax.jit(lambda t, d, i: estep(t, d, i)).lower(
            state.table, state.dense, ids_d
        ).as_text()
        v = comm_volume(schema, B // 8, 8, 2.0, split=sp,
                        dense_param_bytes=0, exchange_bytes=4)
        check(label, txt,
              {"all_to_all": v.ids_a2a + v.rows_a2a_fwd,  # no grad leg
               "all_gather": (v.small_allgather // 8) if sp else 0,
               "all_reduce": 0},
              {"all_to_all": 2,
               "all_gather": n_small if sp else 0,
               "all_reduce": 0})
    lines.append("")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "SCALING.md"))
    args = ap.parse_args()

    from deepctr_tpu.data import ipinyou_full_schema
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.parallel import comm_volume, dense_param_bytes

    schema = ipinyou_full_schema()
    split = make_split_plan(schema)
    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100)))
    db = dense_param_bytes(model, schema)

    lines = []
    lines.append("# SCALING — multi-device exchange accounting\n")
    lines.append(
        "Every byte the sharded step exchanges, accounted in closed form "
        "(`parallel/comm.py` — the capacity formula is IMPORTED by the "
        "executing step, so accounting and execution cannot drift; "
        "tests/test_comm.py pins the algebra) and validated against the "
        "collective buffers in the compiled StableHLO of the actual step on "
        "an 8-device CPU mesh.  These are byte counts, not times: the time "
        "each collective takes on a given interconnect comes from a "
        "measured device trace, not from a model in this file.\n")

    vol = comm_volume(schema, 8192, 4, 2.0, split=split,
                      dense_param_bytes=db)
    lines.append("## Per-step exchange inventory (full-iPinYou FNN, split "
                 "plan, B=8192/device, 4 devices, capacity_factor=2.0, f32 "
                 "wire)\n")
    lines.append(vol.table())
    lines.append(f"\nPer-example wire traffic: "
                 f"{vol.bytes_per_example:.0f} bytes/example/device.\n")

    lines.append("## Wire bytes per device per step, by mesh size and "
                 "exchange settings\n")
    lines.append("| devices | config | wire bytes/dev/step |")
    lines.append("|---|---|---|")
    for n in (2, 4, 8):
        for label, cf, xb in (("cf=2.0, f32 wire", 2.0, 4),
                              ("cf=1.25, bf16 wire", 1.25, 2)):
            v = comm_volume(schema, 8192, n, cf, split=split,
                            dense_param_bytes=db, exchange_bytes=xb)
            lines.append(f"| {n} | {label} | {v.total_wire:,} |")
    lines.append(
        "\nThe row/grad all_to_all of the big embedding fields is the "
        "largest term.  Three settings move it, all implemented and "
        "tested:\n")
    lines.append("- `train.capacity_factor` (default 2.0) directly scales "
                 "the exchange payload; 1.25 still leaves 25% headroom over "
                 "a perfectly balanced shard assignment (drops are counted "
                 "and reported if exceeded).")
    lines.append("- `train.exchange_dtype=bf16` halves the dominant payload "
                 "by casting rows/grads on the wire only (gather -> cast -> "
                 "exchange -> restore; duplicate-id accumulation stays f32; "
                 "trajectory agreement gated in "
                 "tests/test_parallel.py::test_sharded_bf16_exchange_close_to_f32).")
    lines.append("- `train.split_threshold` keeps small fields OFF the "
                 "exchange entirely (all-gathered subtables); without the "
                 "split plan the all_to_all payload grows 6x (18 slots vs "
                 "3 big ones — see tests/test_comm.py).\n")

    if not args.fast:
        hlo_validation(lines)

    from deepctr_tpu.utils.artifacts import protocol_stamp

    lines.append(f"\nGenerated by tools/scaling_report.py at {time.ctime()}. "
                 f"{protocol_stamp('tools/scaling_report.py')}\n")
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
