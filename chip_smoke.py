"""Smoke test of the main path on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one card: train, reference, score
    python chip_smoke.py --cards 4   # the sharded path on four cards only

One card, through the entry points a user calls:

1. device        JAX's backend is a GPU with enough cards (no CPU fallback);
2. train_fnn     the CLI trains FNN at the full iPinYou width (927,658
                 padded rows x 11), B=8192, scan_steps=8, bf16 table,
                 Adagrad on both sides; the loss falls, eval AUC beats the
                 floor, the pad row stays zero, a checkpoint is saved;
3. train_criteo  the CLI trains the Criteo stretch config (26 x 1M hashed
                 buckets, k=16, sorted-Adagrad) unsharded; the loss falls;
4. reference     a few SGD steps of FNN and FM at full iPinYou width,
                 B=8192, against the NumPy reference from the same init:
                 once under "highest" precision (CPU-test tolerance) and
                 once at default precision (TF32 tower matmuls allowed);
5. score         the phase-2 checkpoint scored by ``serving.Scorer`` in
                 f32, bf16 and int8; |dAUC| <= 0.002 against f32.

``--cards 4`` runs the device phase and ``sharded``: the multi-device
dry run (``__graft_entry__.dryrun_multichip``) at the full iPinYou schema
and global B=8192 under "highest" precision, then the CLI's sharded path
on the Criteo stretch config.

Every phase must pass; the first that raises stops the run with exit code
1 and no result line.  The last line of standard output is the result:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Phase times printed on earlier lines are not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

# The program itself: a copy of this script without the repository fails
# here, before any phase.
import deepctr_tpu  # noqa: E402,F401

BATCH = 8192
FNN_CONFIG = os.path.join(REPO, "configs", "fnn_full_ipinyou.json")
CRITEO_CONFIG = os.path.join(REPO, "configs", "criteo_sharded_stretch.json")
# 85% of this trains (2 epochs of 2 scan dispatches of 8 x 8192 rows); the
# rest is the eval split
SYNTHETIC_EXAMPLES = 160_000
# eval AUC floor on the planted data (the FNN reached 0.752 on CPU at the
# same settings; the planted model's own AUC is ~0.8)
AUC_FLOOR = 0.55
SERVING_AUC_BAND = 0.002
# logits vs the NumPy reference: under "highest" the CPU parity tests'
# rtol; at default precision the tower's f32 matmuls may run in TF32, so
# the bound admits the TF32_TF32_F32 dot algorithm and rejects
# BF16_BF16_F32 (on an H100 the FNN's max |dlogit| was 3.8e-5 at default,
# 2.4e-4 with TF32 and 5.5e-4 with bf16, which fails this bound)
HIGHEST_RTOL, HIGHEST_ATOL = 1e-4, 1e-6
DEFAULT_RTOL, DEFAULT_ATOL = 1e-3, 1e-4


class SmokeFailure(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# helpers (pure; tested on CPU)
# ---------------------------------------------------------------------------


def check_devices(backend: str, devices, cards: int):
    """The first ``cards`` GPU devices, or SmokeFailure."""
    _check(backend == "gpu",
           f"JAX's backend is {backend!r}, not 'gpu': no card to test")
    _check(len(devices) >= cards,
           f"{cards} card(s) requested, JAX found {len(devices)}")
    return list(devices)[:cards]


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name, power.limit`` CSV lines (``--format=csv,noheader``) ->
    ``[(name, power_limit), ...]``."""
    out = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        _check(bool(name), f"unexpected nvidia-smi line {line!r}")
        out.append((name.strip(), limit.strip()))
    return out


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


def phases_for(cards: int) -> tuple[str, ...]:
    if cards > 1:
        return ("device", "sharded")
    return ("device", "train_fnn", "train_criteo", "reference", "score")


def _losses_fall(history) -> list[float]:
    losses = [h["train_loss"] for h in history if "train_loss" in h]
    _check(len(losses) >= 2, f"need 2 trained epochs, got {losses}")
    _check(bool(np.all(np.isfinite(losses))), f"non-finite loss {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(ctx):
    import importlib.metadata

    import jax
    import jaxlib

    devices = check_devices(jax.default_backend(), jax.devices(),
                            ctx["cards"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    cards = parse_nvidia_smi(smi)[: len(devices)]
    for line in smi.strip().splitlines()[: len(devices)]:
        print(line)
    ctx["card"] = "; ".join(f"{n}, {p}" for n, p in cards)
    plugins = sorted(
        f"{d.metadata['Name']} {d.version}"
        for d in importlib.metadata.distributions()
        if d.metadata["Name"]
        and d.metadata["Name"].lower().replace("_", "-").startswith("jax-cuda")
    )
    print(f"device_kind: {devices[0].device_kind} x{len(devices)}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"cuda plugin: {', '.join(plugins) or 'none found'}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    ctx["devices"] = devices


def _full_schema_path(ctx) -> str:
    from deepctr_tpu.data import ipinyou_full_schema

    path = os.path.join(ctx["tmp"], "ipinyou_full_schema.json")
    with open(path, "w") as f:
        f.write(ipinyou_full_schema().to_json())
    return path


def fnn_config(ctx):
    from deepctr_tpu.config import RunConfig

    return RunConfig.load(FNN_CONFIG).apply_overrides([
        "model.init_from=none",
        f"data.schema_path={_full_schema_path(ctx)}",
        f"data.synthetic_examples={SYNTHETIC_EXAMPLES}",
        f"train.batch_size={BATCH}", "train.scan_steps=8",
        "train.table_dtype=bf16", "train.epochs=2",
        "train.early_stop_patience=9",
        "optim.sparse=adagrad", "optim.dense=adagrad",
        f"train.checkpoint_path={os.path.join(ctx['tmp'], 'fnn.ckpt')}",
    ])


def phase_train_fnn(ctx):
    from deepctr_tpu.cli import build_model, run
    from deepctr_tpu.utils.checkpoint import load_scoring_params

    cfg = fnn_config(ctx)
    res = run(cfg)
    losses = _losses_fall(res["history"])
    auc = res["history"][-1]["auc"]
    _check(auc > AUC_FLOOR, f"eval AUC {auc:.4f} <= floor {AUC_FLOOR}")
    from deepctr_tpu.data import Schema

    with open(cfg.data.schema_path) as f:
        schema = Schema.from_json(f.read())
    model = build_model(cfg, schema)
    import jax

    dense_like = model.init_params(jax.random.PRNGKey(0), schema)["dense"]
    table, _ = load_scoring_params(cfg.train.checkpoint_path, dense_like)
    pad_row = np.asarray(table[schema.pad_id], np.float32)
    _check(not pad_row.any(), f"pad row changed: {pad_row}")
    ctx.update(fnn_cfg=cfg, fnn_auc=auc)
    print(f"train_fnn: losses {losses}, eval AUC {auc:.4f}, "
          f"{res['history'][-1]['examples_per_s']:,.0f} ex/s in the last "
          f"epoch (host clock, not a benchmark; {ctx.get('card', '')})")


def phase_train_criteo(ctx):
    from deepctr_tpu.cli import run
    from deepctr_tpu.config import RunConfig

    cfg = RunConfig.load(CRITEO_CONFIG).apply_overrides([
        "train.sharded=false", f"data.synthetic_examples={SYNTHETIC_EXAMPLES}",
        "train.epochs=2", "train.early_stop_patience=9",
    ])
    res = run(cfg)
    losses = _losses_fall(res["history"])
    print(f"train_criteo: sparse_mode={cfg.optim.sparse_mode}, "
          f"{cfg.data.criteo_cat_buckets:,} buckets x 26, losses {losses}, "
          f"eval AUC {res['history'][-1]['auc']:.4f}")


def _trajectory(kind: str, schema, batches, eval_ids, precision: str):
    """``(jax_logits, ref_logits, max_param_dev)`` after SGD on ``batches``
    from the NumPy reference's init (the tests/test_parity.py harness, at
    full width and with the production split plan)."""
    import jax
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.models import FMModel, MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.optim import SparseSgd
    from deepctr_tpu.reference_impl import NumpyFM, NumpyFNN
    from deepctr_tpu.train import init_state, make_train_step
    from deepctr_tpu.train.step import make_eval_step

    lr = 0.05
    if kind == "fm":
        ref = NumpyFM(schema, k=10, lr=lr, seed=11)
        model = FMModel(k=10)
    else:
        ref = NumpyFNN(schema, k=10, hidden=(200, 300, 100), lr=lr, seed=12)
        model = make_fnn(schema, k=10,
                         mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.0))
    dopt = optax.sgd(lr)
    st = init_state(model, schema, SparseSgd(lr), dopt, seed=0)
    st = st._replace(table=jnp.asarray(ref.table.copy()))
    if kind == "fnn":
        dense = {"mlp": {"layers": [
            {"w": jnp.asarray(w.copy()), "b": jnp.asarray(b.copy())}
            for w, b in ref.layers]}}
        st = st._replace(dense=dense, dense_state=dopt.init(dense))
    split = make_split_plan(schema)
    with jax.default_matmul_precision(precision):
        step = make_train_step(model, schema, SparseSgd(lr), dopt,
                               split=split)
        for ids, y in batches:
            ref.train_batch(ids, y)
            st, _ = step(st, ids, y, np.ones(len(y), np.float32))
        got = np.asarray(make_eval_step(model, schema, split=split)(
            st.table, st.dense, jnp.asarray(eval_ids)))
    dev = float(np.max(np.abs(np.asarray(st.table) - ref.table)))
    return got, ref.forward(eval_ids), dev


def phase_reference(ctx, steps: int = 3):
    from deepctr_tpu.data import ipinyou_full_schema, synthetic

    schema = ipinyou_full_schema()
    ds = synthetic.generate(schema, num_examples=(steps + 1) * BATCH, seed=5)
    batches = [(ds.ids[i * BATCH:(i + 1) * BATCH],
                ds.labels[i * BATCH:(i + 1) * BATCH]) for i in range(steps)]
    eval_ids = ds.ids[steps * BATCH:]
    for kind in ("fm", "fnn"):
        for precision, rtol, atol in (
            ("highest", HIGHEST_RTOL, HIGHEST_ATOL),
            ("default", DEFAULT_RTOL, DEFAULT_ATOL),
        ):
            got, want, table_dev = _trajectory(kind, schema, batches,
                                               eval_ids, precision)
            err = np.abs(got - want)
            print(f"reference {kind} {precision}: max |dlogit| "
                  f"{err.max():.3e} (max |logit| {np.abs(want).max():.3e}), "
                  f"max |dtable| {table_dev:.3e}")
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def phase_score(ctx):
    from deepctr_tpu.cli import build_model, load_data
    from deepctr_tpu.serving import Scorer
    from deepctr_tpu.utils.metrics import exact_auc

    cfg = ctx["fnn_cfg"]
    schema, _, _, te_ids, te_labels = load_data(cfg)
    model = build_model(cfg, schema)
    aucs = {}
    for mode in (None, "bf16", "int8"):
        scorer = Scorer.from_checkpoint(cfg.train.checkpoint_path, model,
                                        schema, batch_size=BATCH,
                                        quantize=mode)
        logits = scorer.logits(te_ids)
        _check(logits.shape == (len(te_ids),) and np.isfinite(logits).all(),
               f"{mode or 'f32'} scorer: bad logits {logits.shape}")
        aucs[mode or "f32"] = exact_auc(te_labels, logits)
    print(f"score: AUC {aucs} (training eval {ctx['fnn_auc']:.4f})")
    for mode in ("bf16", "int8"):
        d = aucs[mode] - aucs["f32"]
        _check(abs(d) <= SERVING_AUC_BAND,
               f"{mode} scorer dAUC {d:+.5f} outside +-{SERVING_AUC_BAND}")


def phase_sharded(ctx):
    import jax

    import __graft_entry__ as graft
    from deepctr_tpu.cli import run
    from deepctr_tpu.config import RunConfig
    from deepctr_tpu.data import ipinyou_full_schema

    devices = ctx["devices"]
    with jax.default_matmul_precision("highest"):
        print(graft.dryrun_multichip(devices, schema=ipinyou_full_schema(),
                                     batch=BATCH))
    cfg = RunConfig.load(CRITEO_CONFIG).apply_overrides([
        f"data.synthetic_examples={SYNTHETIC_EXAMPLES}", "train.epochs=2",
        "train.early_stop_patience=9", f"train.num_devices={len(devices)}",
    ])
    _check(cfg.train.sharded, "the Criteo stretch config ships sharded")
    res = run(cfg)
    losses = _losses_fall(res["history"])
    print(f"sharded CLI on {len(devices)} cards: losses {losses}, dropped "
          f"ids {[h['dropped_ids'] for h in res['history']]}, eval AUC "
          f"{res['history'][-1]['auc']:.4f}")


PHASES = {
    "device": phase_device,
    "train_fnn": phase_train_fnn,
    "train_criteo": phase_train_criteo,
    "reference": phase_reference,
    "score": phase_score,
    "sharded": phase_sharded,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    # only the cards this run uses are opened (JAX reserves most of each
    # card's memory as it opens it)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES",
                          ",".join(str(i) for i in range(args.cards)))
    from deepctr_tpu.utils.compile_cache import configure_compile_cache

    print(f"compile cache: {configure_compile_cache()}")
    ctx = {"cards": args.cards}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ctx["tmp"] = tmp
        for name in phases_for(args.cards):
            t0 = time.perf_counter()
            try:
                PHASES[name](ctx)
            except Exception:
                traceback.print_exc()
                print(f"phase {name}: FAILED after "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                return 1
            print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
                  f"({ctx.get('card', 'card not read yet')})", flush=True)
    print(result_line(ctx["devices"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
