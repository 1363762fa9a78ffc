"""Config system + CLI end-to-end tests (SURVEY.md §5 config row)."""

import json

import numpy as np
import pytest

from deepctr_tpu.cli import main, run
from deepctr_tpu.config import RunConfig


def test_config_roundtrip_and_overrides():
    cfg = RunConfig()
    cfg2 = RunConfig.from_json(cfg.to_json())
    assert cfg == cfg2
    cfg3 = cfg.apply_overrides(
        ["model.name=fm", "train.epochs=3", "optim.sparse_lr=0.5",
         "model.hidden=64,32", "train.prefetch=false"]
    )
    assert cfg3.model.name == "fm"
    assert cfg3.train.epochs == 3
    assert cfg3.optim.sparse_lr == 0.5
    assert cfg3.model.hidden == (64, 32)
    assert cfg3.train.prefetch is False


def test_config_rejects_unknown_keys():
    with pytest.raises(ValueError):
        RunConfig().apply_overrides(["model.nonexistent=1"])
    with pytest.raises(ValueError):
        RunConfig.from_dict({"model": {"bogus": 1}})


def test_config_rejects_use_pallas():
    """The Pallas kernels and their switch are gone; an old config that
    still sets it is refused rather than silently ignored."""
    with pytest.raises(ValueError, match="use_pallas"):
        RunConfig().apply_overrides(["model.use_pallas=true"])
    with pytest.raises(ValueError, match="use_pallas"):
        RunConfig.from_dict({"model": {"use_pallas": False}})


def test_bundled_configs_parse():
    import glob
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
    paths = glob.glob(os.path.join(root, "*.json"))
    assert len(paths) >= 5
    for p in paths:
        RunConfig.load(p)


def test_cli_end_to_end_fm_then_fnn(tmp_path):
    """Two-phase flow through the CLI: train FM -> checkpoint -> FNN init."""
    ckpt = str(tmp_path / "fm.ckpt")
    fm_cfg = RunConfig().apply_overrides(
        [
            "model.name=fm",
            "model.k=4",
            "data.synthetic_examples=6000",
            "train.batch_size=512",
            "train.epochs=2",
            "train.prefetch=false",
            f"train.checkpoint_path={ckpt}",
            f"train.metrics_path={tmp_path}/fm_metrics.jsonl",
        ]
    )
    res_fm = run(fm_cfg)
    assert res_fm["best_auc"] > 0.55

    fnn_cfg = RunConfig().apply_overrides(
        [
            "model.name=fnn",
            "model.k=4",
            "model.hidden=32,16",
            "model.dropout=0.0",
            f"model.init_from={ckpt}.fm_table",
            "data.synthetic_examples=6000",
            "train.batch_size=512",
            "train.epochs=2",
            "train.prefetch=false",
        ]
    )
    res_fnn = run(fnn_cfg)
    assert res_fnn["best_auc"] > 0.55
    # metrics file is valid JSONL
    lines = open(f"{tmp_path}/fm_metrics.jsonl").read().splitlines()
    assert all(json.loads(ln) for ln in lines)


def test_cli_sharded_snn_with_pretrain(tmp_path, monkeypatch):
    """SNN with DAE pretrain on the sharded multi-device path (the
    BASELINE.json:10 'SNN multi-chip' config, shrunk).

    Regression (round-1 VERDICT weak #1): the sharded loop must CONSUME the
    pretrained state, not re-init from the seed — we spy on the state
    handoff and assert the initial sharded table equals the pretrained one.
    """
    import jax

    import deepctr_tpu.parallel as par
    from deepctr_tpu.cli import build_model, build_optimizers, load_data
    from deepctr_tpu.parallel import unpack_table
    from deepctr_tpu.train import init_state

    cfg = RunConfig().apply_overrides(
        [
            "model.name=snn",
            "model.hidden1=16",
            "model.hidden=16",
            "model.dropout=0.0",
            "data.synthetic_examples=4000",
            "train.batch_size=512",
            "train.epochs=1",
            "train.pretrain=dae",
            "train.pretrain_epochs=1",
            "train.sharded=true",
            "train.capacity_factor=8.0",
            "train.prefetch=false",
        ]
    )
    captured = {}
    orig = par.sharded_state_from_state

    def spy(state, mesh):
        captured["table"] = np.asarray(state.table).copy()
        sst = orig(state, mesh)
        captured["sharded_table"] = np.asarray(sst.table).copy()
        return sst

    monkeypatch.setattr(par, "sharded_state_from_state", spy)
    res = run(cfg)
    assert np.isfinite(res["best_auc"])

    schema, *_ = load_data(cfg)
    # the state handed to the sharded loop must differ from a fresh init
    # (pretraining modified the table) ...
    model = build_model(cfg, schema)
    sopt, dopt = build_optimizers(cfg)
    fresh = init_state(model, schema, sopt, dopt, seed=cfg.train.seed)
    assert not np.allclose(captured["table"], np.asarray(fresh.table))
    # ... and the packed sharded table must equal the pretrained table
    got = np.asarray(
        unpack_table(
            captured["sharded_table"], schema.padded_vocab_size,
            len(jax.devices()),
        )
    )
    np.testing.assert_array_equal(got, captured["table"])


def _ckpt_table(path):
    import json as _json

    with np.load(path, allow_pickle=False) as z:
        m = _json.loads(str(z["manifest"]))
        return np.asarray(z[f"leaf_{m['scoring']['table_leaf']}"])


@pytest.mark.parametrize("scan_steps", [0, 2])
def test_cli_sharded_matches_unsharded(tmp_path, scan_steps):
    """End-to-end CLI parity: the sharded loop (prefetch + lr_decay + scan)
    must produce the same trained table as the single-device loop."""
    base = [
        "model.name=fm",
        "model.k=3",
        "data.synthetic_examples=4000",
        "train.batch_size=512",
        "train.epochs=2",
        "train.lr_decay=0.5",
        f"train.scan_steps={scan_steps}",
        "train.capacity_factor=8.0",
    ]
    ck1 = str(tmp_path / "single.npz")
    ck8 = str(tmp_path / "sharded.npz")
    run(RunConfig().apply_overrides(
        base + ["train.prefetch=false", f"train.checkpoint_path={ck1}"]
    ))
    run(RunConfig().apply_overrides(
        base + ["train.sharded=true", "train.prefetch=true",
                f"train.checkpoint_path={ck8}"]
    ))
    np.testing.assert_allclose(
        _ckpt_table(ck1), _ckpt_table(ck8), rtol=1e-4, atol=1e-5
    )


def test_cli_sharded_kill_resume_matches_uninterrupted(tmp_path):
    """Sharded fault tolerance: 2 epochs + resume-to-3 == 3 uninterrupted
    epochs, bitwise (checkpoint carries table, Adagrad acc, RNG, epoch)."""
    base = [
        "model.name=fm",
        "model.k=3",
        "data.synthetic_examples=4000",
        "train.batch_size=512",
        "train.sharded=true",
        "train.capacity_factor=8.0",
        "train.prefetch=false",
        "train.lr_decay=0.7",
    ]
    ck_a = str(tmp_path / "uninterrupted.npz")
    ck_b = str(tmp_path / "resumed.npz")
    run(RunConfig().apply_overrides(
        base + ["train.epochs=3", f"train.checkpoint_path={ck_a}"]
    ))
    run(RunConfig().apply_overrides(
        base + ["train.epochs=2", f"train.checkpoint_path={ck_b}"]
    ))
    run(RunConfig().apply_overrides(
        base + ["train.epochs=3", "train.resume=true",
                f"train.checkpoint_path={ck_b}"]
    ))
    np.testing.assert_array_equal(_ckpt_table(ck_a), _ckpt_table(ck_b))


def test_cli_criteo_sharded_sorted_mode(tmp_path, monkeypatch):
    """The Criteo stretch path end to end (BASELINE.json:11, shrunk): raw
    Criteo TSV -> hash-trick schema -> sharded training with the
    vocab-independent sorted Adagrad, which must (a) actually run and
    (b) reproduce the dense-scratch trajectory."""
    import deepctr_tpu.optim.sparse as sparse_mod

    # write a small raw Criteo TSV
    rng = np.random.default_rng(0)
    path = str(tmp_path / "day0.tsv")
    with open(path, "w") as f:
        for i in range(3000):
            label = int(rng.random() < 0.25)
            ints = [str(int(rng.integers(0, 1000))) if rng.random() > 0.1 else ""
                    for _ in range(13)]
            cats = [f"{int(rng.integers(0, 500)):08x}" if rng.random() > 0.1 else ""
                    for _ in range(26)]
            f.write("\t".join([str(label)] + ints + cats) + "\n")

    base = [
        "model.name=fnn", "model.k=3", "model.hidden=16", "model.dropout=0.0",
        "data.format=criteo", "data.criteo_cat_buckets=2000",
        f"data.train_path={path}",
        "train.batch_size=256", "train.epochs=2", "train.sharded=true",
        "train.capacity_factor=8.0", "train.prefetch=false",
        "train.split_threshold=100",  # cat fields -> big class (real scatter)
    ]
    calls = {"n": 0}
    orig = sparse_mod.dedupe_grads

    def spy(ids, rows, ids_sorted=False):
        calls["n"] += 1
        return orig(ids, rows, ids_sorted=ids_sorted)

    monkeypatch.setattr(sparse_mod, "dedupe_grads", spy)

    ck_sorted = str(tmp_path / "sorted.npz")
    res = run(RunConfig().apply_overrides(
        base + ["optim.sparse_mode=sorted",
                f"train.checkpoint_path={ck_sorted}"]
    ))
    assert np.isfinite(res["best_auc"])
    assert calls["n"] > 0, "sorted (segmented-scan) path never ran"

    ck_dense = str(tmp_path / "dense.npz")
    run(RunConfig().apply_overrides(
        base + ["optim.sparse_mode=dense", f"train.checkpoint_path={ck_dense}"]
    ))
    np.testing.assert_allclose(
        _ckpt_table(ck_sorted), _ckpt_table(ck_dense), rtol=1e-4, atol=1e-5
    )


def test_cli_criteo_stretch_config_runs_shrunk(tmp_path):
    """The bundled stretch config itself (shrunk overrides) must drive the
    criteo+sharded+sorted+scan path end to end."""
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
    cfg = RunConfig.load(os.path.join(root, "criteo_sharded_stretch.json"))
    assert cfg.data.format == "criteo"
    assert cfg.optim.sparse_mode == "sorted"
    assert cfg.train.sharded
    cfg = cfg.apply_overrides([
        "model.k=3", "model.hidden=16", "model.dropout=0.0",
        "data.criteo_cat_buckets=500", "data.synthetic_examples=2000",
        "train.batch_size=256", "train.epochs=1", "train.scan_steps=2",
        "train.capacity_factor=8.0", "train.prefetch=false",
    ])
    res = run(cfg)
    assert np.isfinite(res["best_auc"])


def test_cli_criteo_stream_stretch_config_runs_shrunk(tmp_path):
    """The streaming stretch config (shrunk): criteo shards stream through
    the native parser into the sharded loop with bf16 wire exchange —
    bounded-RAM by construction (VERDICT r2 Missing #3)."""
    import os

    rng = np.random.default_rng(1)

    def write_day(path, n):
        with open(path, "w") as f:
            for i in range(n):
                ints = [str(rng.integers(0, 50)) if rng.random() > 0.2 else ""
                        for _ in range(13)]
                cats = [f"{rng.integers(0, 40):06x}" if rng.random() > 0.2
                        else "" for _ in range(26)]
                f.write("\t".join([str(int(rng.random() < 0.3))] + ints + cats)
                        + "\n")

    for i in range(2):
        write_day(str(tmp_path / f"day_{i}.tsv"), 1500)
    write_day(str(tmp_path / "day_eval.tsv"), 400)

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
    cfg = RunConfig.load(os.path.join(root, "criteo_stream_stretch.json"))
    assert cfg.data.stream and cfg.train.exchange_dtype == "bf16"
    cfg = cfg.apply_overrides([
        "model.k=3", "model.hidden=16", "model.dropout=0.0",
        "data.criteo_cat_buckets=500",
        f"data.train_path={tmp_path}/day_0.tsv,{tmp_path}/day_1.tsv",
        f"data.test_path={tmp_path}/day_eval.tsv",
        "data.stream_buffer_rows=1024",
        "train.batch_size=256", "train.epochs=1", "train.scan_steps=2",
        "train.capacity_factor=8.0", "train.prefetch=false",
        "train.num_devices=4",
    ])
    res = run(cfg)
    assert np.isfinite(res["best_auc"])


def test_cli_print_config(capsys):
    assert main(["--print-config", "model.name=lr"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out)["model"]["name"] == "lr"


def test_cli_resume_from_checkpoint(tmp_path):
    """Kill-and-restart fault tolerance: resume picks up the saved step."""
    ckpt = str(tmp_path / "resume.ckpt")
    base = [
        "model.name=fm",
        "model.k=3",
        "data.synthetic_examples=4000",
        "train.batch_size=512",
        "train.prefetch=false",
        f"train.checkpoint_path={ckpt}",
        f"train.metrics_path={tmp_path}/m.jsonl",
    ]
    run(RunConfig().apply_overrides(base + ["train.epochs=2"]))
    import os

    assert os.path.exists(ckpt)
    res = run(
        RunConfig().apply_overrides(
            base + ["train.epochs=1", "train.resume=true"]
        )
    )
    lines = [json.loads(ln) for ln in open(f"{tmp_path}/m.jsonl")]
    resumed = [l for l in lines if l.get("event") == "resumed"]
    assert resumed and resumed[0]["step"] > 0
    assert np.isfinite(res["best_auc"])


def test_cli_score_surface(tmp_path, capsys):
    """Train -> checkpoint -> --score a yx file (the pred_fn role)."""
    from deepctr_tpu.data import make_schema, synthetic

    schema = make_schema([("a", 6), ("b", 12), ("c", 20)])
    ds = synthetic.generate(schema, num_examples=2000, k=3, seed=5)
    sp = str(tmp_path / "schema.json")
    open(sp, "w").write(schema.to_json())
    yx = str(tmp_path / "score_me.yx")
    synthetic.write_yx_file(
        synthetic.SyntheticDataset(schema, ds.ids[:300], ds.labels[:300],
                                   ds.bayes_logits[:300]), yx)
    tr = str(tmp_path / "tr.yx")
    synthetic.write_yx_file(ds, tr)
    ckpt = str(tmp_path / "m.ckpt")
    base = [
        "model.name=fm", "model.k=3", f"data.schema_path={sp}",
        f"data.train_path={tr}", "train.batch_size=256", "train.epochs=2",
        "train.prefetch=false", f"train.checkpoint_path={ckpt}",
    ]
    run(RunConfig().apply_overrides(base))
    capsys.readouterr()
    assert main(base + ["--score", yx]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    probs = np.asarray([float(x) for x in out])
    assert len(probs) == 300
    assert ((probs >= 0) & (probs <= 1)).all()
    # scores must rank the labels meaningfully (AUC > chance)
    from deepctr_tpu.utils.metrics import exact_auc

    assert exact_auc(ds.labels[:300], probs) > 0.55


def test_cli_score_featindex_uses_checkpoint_schema(tmp_path, capsys):
    """Round-2 gap (VERDICT Weak #3): a featindex-trained checkpoint must
    score under the schema it TRAINED with (from the manifest), with the yx
    ids remapped through the featindex — not the ipinyou_like fallback."""
    import jax

    from deepctr_tpu.data import featindex as fidx
    from deepctr_tpu.serving import Scorer
    from deepctr_tpu.utils.checkpoint import read_manifest
    from deepctr_tpu.cli import build_model

    fp = tmp_path / "featindex.txt"
    # interleaved per-field old-index ranges, as make-ipinyou-data emits
    lines = ["truncate\t0"]
    old = 1
    for val in range(5):
        for field in ("weekday", "hour", "region"):
            lines.append(f"{field}:{val}\t{old}")
            old += 1
    fp.write_text("\n".join(lines) + "\n")

    rng = np.random.default_rng(3)
    def make_yx(n):
        rows = []
        for _ in range(n):
            picks = [1 + 3 * rng.integers(0, 5) + f for f in range(3)]
            y = int(rng.random() < 0.4)
            rows.append(f"{y} " + " ".join(f"{p}:1" for p in picks))
        return "\n".join(rows) + "\n"

    tr = tmp_path / "train.yx"
    tr.write_text(make_yx(400))
    sc = tmp_path / "score_me.yx"
    sc.write_text(make_yx(50))
    ckpt = str(tmp_path / "m.ckpt")
    base = [
        "model.name=fm", "model.k=2", f"data.featindex_path={fp}",
        f"data.train_path={tr}", "data.use_cache=false",
        "train.batch_size=64", "train.epochs=1", "train.prefetch=false",
        f"train.checkpoint_path={ckpt}",
    ]
    run(RunConfig().apply_overrides(base))

    # the manifest carries the featindex-derived schema
    fi = fidx.load_featindex(str(fp))
    manifest = read_manifest(ckpt)
    assert json.loads(manifest["schema_json"]) == json.loads(fi.schema.to_json())

    capsys.readouterr()
    assert main(base + ["--score", str(sc)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    probs = np.asarray([float(x) for x in out])
    assert len(probs) == 50

    # must match in-process predictions under the featindex remap exactly
    model = build_model(RunConfig().apply_overrides(base), fi.schema)
    scorer = Scorer.from_checkpoint(ckpt, model)  # schema from the manifest
    _, ids = fidx.parse_yx_file(str(sc), fi)
    np.testing.assert_allclose(probs, scorer.predict(ids), atol=1e-5)

    # a mismatched schema is an ERROR, not silent garbage
    from deepctr_tpu.data import ipinyou_like_schema

    wrong = ipinyou_like_schema()
    with pytest.raises(ValueError, match="schema mismatch"):
        Scorer.from_checkpoint(ckpt, build_model(
            RunConfig().apply_overrides(base), wrong), wrong)
