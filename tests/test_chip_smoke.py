"""chip_smoke.py: its contract, checked here without a card.

The card phases themselves run on a GPU (``python chip_smoke.py``); here
the pure helpers, the phase selection, the failure paths and the sharded
dry run on virtual CPU devices are checked.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = kind


def test_check_devices_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.check_devices("cpu", [_Dev("cpu")] * 8, 1)


def test_check_devices_refuses_too_few_cards():
    with pytest.raises(cs.SmokeFailure, match="4 card"):
        cs.check_devices("gpu", [_Dev()], 4)
    assert len(cs.check_devices("gpu", [_Dev()] * 8, 4)) == 4


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n"
     "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "500.00 W")]
     + [("NVIDIA H100 80GB HBM3", "700.00 W")] * 2),
])
def test_parse_nvidia_smi(text, want):
    assert cs.parse_nvidia_smi(text) == want


def test_result_line_has_exactly_the_contract_keys():
    line = cs.result_line([_Dev()] * 4)
    got = json.loads(line)
    assert got == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("cards", [1, 4])
def test_phase_selection(cards):
    phases = cs.phases_for(cards)
    assert phases[0] == "device"
    assert set(phases) <= set(cs.PHASES)
    if cards == 4:
        assert phases == ("device", "sharded")
    else:
        assert "sharded" not in phases
        assert {"train_fnn", "train_criteo", "reference", "score"} <= set(phases)


def test_raising_phase_exits_nonzero_without_result(monkeypatch, capsys):
    ran = []

    def device(ctx):
        ran.append("device")
        ctx["devices"] = [_Dev()]

    def broken(ctx):
        ran.append("broken")
        raise cs.SmokeFailure("planted failure")

    def after(ctx):
        ran.append("after")

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(os.getcwd()))
    monkeypatch.setattr(cs, "phases_for",
                        lambda cards: ("device", "broken", "after"))
    monkeypatch.setattr(cs, "PHASES",
                        {"device": device, "broken": broken, "after": after})
    assert cs.main([]) == 1
    assert ran == ["device", "broken"]  # nothing after the failure runs
    out = capsys.readouterr().out
    assert "phase broken: FAILED" in out
    assert '"ok"' not in out


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_exits_nonzero_on_cpu_before_any_phase():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert "phase device: FAILED" in out.stdout
    assert "phase device: ok" not in out.stdout
    assert '"ok"' not in out.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fnn_config_is_the_flagship_at_full_width(tmp_path):
    from deepctr_tpu.data import Schema

    cfg = cs.fnn_config({"tmp": str(tmp_path)})
    m, t, o = cfg.model, cfg.train, cfg.optim
    assert (m.name, m.k, m.hidden, m.dropout, m.init_from) == (
        "fnn", 10, (200, 300, 100), 0.5, None)
    assert (t.batch_size, t.scan_steps, t.table_dtype) == (8192, 8, "bf16")
    assert (o.sparse, o.dense) == ("adagrad", "adagrad")
    with open(cfg.data.schema_path) as f:
        schema = Schema.from_json(f.read())
    assert (schema.padded_vocab_size, schema.num_fields * (1 + m.k)) == (
        927_658, 176)
    # at least 2 scan dispatches per epoch
    n_train = int(cfg.data.synthetic_examples * (1 - cfg.data.test_fraction))
    assert n_train // (t.batch_size * t.scan_steps) >= 2


@pytest.mark.parametrize("as_count", [False, True])
def test_dryrun_multichip_on_4_cpu_devices(as_count):
    """The ``--cards 4`` dry run, rehearsed on four virtual CPU devices,
    given as a device list or as a count of ``jax.devices()``."""
    import jax

    import __graft_entry__ as graft

    devices = 4 if as_count else jax.devices("cpu")[:4]
    summary = graft.dryrun_multichip(devices)
    assert summary.startswith("dryrun_multichip(4 x cpu, B=64): ok")


def test_dryrun_multichip_count_refuses_too_few_devices():
    import jax

    import __graft_entry__ as graft

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        graft.dryrun_multichip(n)


@pytest.mark.gpu
def test_reference_phase_on_gpu(gpu_device):
    """Full-width FNN/FM trajectories vs the NumPy reference on the card."""
    import jax

    with jax.default_device(gpu_device):
        cs.phase_reference({})


def test_program_has_no_foreign_kernel_dialect_or_interpret_switch():
    """No import of the other accelerator's Pallas dialect, no branch on
    its platform name and no automatic interpreter switch in the code that
    runs on the device.  (``t[p]u`` keeps the pattern itself out of a text
    search for the name.)"""
    import re

    bad = re.compile(
        r"pallas\.t[p]u|pallas import t[p]u|plt[p]u|libt[p]u"
        r"|platform\s*[!=]=\s*[\"']t[p]u[\"']"
        r"|default_backend\(\)\s*[!=]=\s*[\"']t[p]u"
        r"|interpret\s*=\s*True"
    )
    roots = [os.path.join(REPO, "deepctr_tpu"), os.path.join(REPO, "tools")]
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "__graft_entry__.py", "chip_smoke.py")]
    for root in roots:
        for d, _, names in os.walk(root):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if bad.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert len(files) > 40
    assert not hits, "\n".join(hits)
