"""Evidence-artifact freshness + self-consistency gates.

VERDICT r3 Weak #1: PARITY.md shipped stale two rounds running — generated
by an older protocol than the tool at HEAD, with rows violating the band the
same file declares.  These tests make that drift mechanically impossible
(VERDICT r3 ask #1):

1. every generated evidence artifact must carry a ``protocol: <tool>@<hash>``
   stamp matching a digest of the generating tool's source at HEAD — any
   edit to a tool invalidates its artifact until the tool is re-run;
2. each artifact's own table must satisfy the acceptance criterion the
   artifact itself declares (PARITY.md's per-row ``band`` column).
"""

import os

import pytest

from deepctr_tpu.utils.artifacts import (
    REPO_ROOT,
    float_or_none,
    parse_md_table,
    read_stamp,
    tool_hash,
)

# artifact -> generating tool (both repo-relative)
ARTIFACTS = {
    "PARITY.md": "tools/parity_report.py",
    "SCALING.md": "tools/scaling_report.py",
    "RESULTS.md": "tools/reproduce.py",
}


@pytest.mark.parametrize("artifact,tool", sorted(ARTIFACTS.items()))
def test_artifact_generated_by_current_protocol(artifact, tool):
    path = os.path.join(REPO_ROOT, artifact)
    assert os.path.exists(path), f"{artifact} missing — run {tool}"
    stamp = read_stamp(path)
    assert stamp is not None, (
        f"{artifact} carries no protocol stamp — it predates the freshness "
        f"gate; regenerate with `python {tool}`"
    )
    rec_tool, rec_hash = stamp
    assert rec_tool == tool, (
        f"{artifact} claims generator {rec_tool}, expected {tool}"
    )
    assert rec_hash == tool_hash(tool), (
        f"{artifact} was generated by an OLD version of {tool} "
        f"(stamp {rec_hash}, HEAD {tool_hash(tool)}) — regenerate it"
    )


def test_parity_rows_respect_their_own_band():
    """No PARITY.md row may violate the band the same row declares."""
    with open(os.path.join(REPO_ROOT, "PARITY.md")) as f:
        rows = parse_md_table(f.read())
    assert rows, "PARITY.md has no parseable table"
    assert {"Δ AUC", "band", "ok"} <= set(rows[0]), (
        "PARITY.md table lacks the per-row band columns — stale format"
    )
    for r in rows:
        delta = float_or_none(r["Δ AUC"])
        band = float_or_none(r["band"])
        assert delta is not None and band is not None, r
        assert abs(delta) <= band + 1e-9, (
            f"PARITY.md row {r['model']} out of its own band: "
            f"|{delta}| > {band}"
        )
        assert r["ok"] == "yes", f"row {r['model']} self-reports failure"


def test_parity_covers_full_model_family():
    """The parity table must include every reference model (SURVEY.md §2.1
    C4-C8), each SNN variant decomposed into its two protocol rows."""
    with open(os.path.join(REPO_ROOT, "PARITY.md")) as f:
        rows = parse_md_table(f.read())
    names = {r["model"].lower() for r in rows}
    for want in ("lr", "fm", "fnn",
                 "snn_dae supervised", "snn_dae pretrain-matched",
                 "snn_dae pretrain-swap",
                 "snn_rbm supervised", "snn_rbm pretrain-matched",
                 "snn_rbm pretrain-swap"):
        assert want in names, f"PARITY.md missing row: {want}"


def test_scaling_hlo_validation_rows_all_match():
    """SCALING.md's compiled-vs-accounted table must not ship a NO row."""
    with open(os.path.join(REPO_ROOT, "SCALING.md")) as f:
        text = f.read()
    assert "Validation against the compiled program" in text
    assert "| NO |" not in text, "a compiled-HLO validation row mismatched"
