"""Multi-host DCN simulation (SURVEY.md §2.4 comm row): two OS processes
joined via jax.distributed.initialize form one 8-device global mesh; the
sharded trajectory must equal a single-process run.  The heavy lifting is
tools/multihost_sim.py — this test drives it end to end."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_dcn_trajectory_matches_single_process():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO  # this repo only, as the workers get
    env.pop("XLA_FLAGS", None)  # launcher/workers set their own device count
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_sim.py")],
        env=env, capture_output=True, text=True, timeout=1500,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIHOST SIM OK" in out.stdout, out.stdout + out.stderr
    # phase 2: process-aware streaming (disjoint shard subsets per process,
    # process-local batch assembly, recommended cf=1.25 + bf16-wire recipe)
    assert "MULTIHOST STREAM OK" in out.stdout, out.stdout + out.stderr
    # phase 3: kill-one-host fault drill — worker 1 dies mid-step, the
    # survivor's collective must stall (failure detectable), and a fresh
    # cluster restored from per-host shard checkpoints
    # (parallel/hostckpt.py) matches the uninterrupted trajectory
    assert "MULTIHOST FAULT OK" in out.stdout, out.stdout + out.stderr
    # phase 4: the real CLI in a 2-process cluster — trains, saves
    # hostshards, is interrupted, resumes, and matches the uninterrupted
    # single-process CLI run (covers cli.py's multi-controller branches)
    assert "MULTIHOST CLI OK" in out.stdout, out.stdout + out.stderr
    # phase 5: the PRODUCTION shape in one run (VERDICT r4 Missing #6) —
    # cli.run + data.stream (disjoint per-process shards) + FNN split plan
    # + cf=1.25 + bf16 wire + scan/prefetch + hostshards interrupt/resume;
    # resumed epoch must equal the uninterrupted 2-process cluster run
    assert "MULTIHOST STREAM-CLI OK" in out.stdout, out.stdout + out.stderr
