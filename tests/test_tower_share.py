"""tools/tower_share.py: the op grouping and the trace reduction, on
recorded-shape events and on the scan step's compiled HLO (CPU)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import tower_share as ts  # noqa: E402

BODY = "jit(scan_step)/while/body/closed_call"


@pytest.mark.parametrize("op_name,group", [
    (f"{BODY}/transpose(jvp(onehot_lookup))/blv,vd->bld/dot_general",
     "onehot_lookup_bwd"),
    (f"{BODY}/jvp(onehot_lookup)/eq", "onehot_lookup_fwd"),
    (f"{BODY}/transpose(jvp(dense_tower))/dot_general", "dense_tower_bwd"),
    (f"{BODY}/jvp(dense_tower)/convert_element_type", "dense_tower_fwd"),
    (f"{BODY}/convert_element_type", "convert_element_type"),
    (f"{BODY}/dynamic_update_slice", "dynamic_update_slice"),
    (f"{BODY}/transpose(jvp())/scatter-add", "scatter"),
    (f"{BODY}/sort", "sort"),
    (f"{BODY}/jit(_take)/gather", "gather"),
    (f"{BODY}/mul", "other"),
    (None, "unattributed"),
])
def test_op_group(op_name, group):
    assert ts.op_group(op_name) == group


def _names():
    return {"fus.1": f"{BODY}/transpose(jvp(onehot_lookup))/dot_general",
            "fus.2": f"{BODY}/jvp(dense_tower)/dot_general",
            "fus.3": f"{BODY}/sort"}


def test_summarize_groups_busy_and_idle():
    # two steps; fus.2 overlaps fus.1 by 10 ns on another stream; a 20 ns
    # gap before the last op
    events = [(0, 50, "fus.1"), (40, 30, "fus.2"), (90, 10, "fus.3"),
              (100, 20, "unknown.7")]
    got = ts.summarize(events, _names(), steps=2)
    assert got["op_ms_per_step"] == pytest.approx(110 / 2 / 1e6)
    assert got["device_busy_ms_per_step"] == pytest.approx(100 / 2 / 1e6)
    assert got["device_idle_share"] == pytest.approx(20 / 120)
    assert got["tower_ms_per_step"] == pytest.approx(30 / 2 / 1e6)
    assert got["tower_share_of_op_time"] == pytest.approx(30 / 110)
    groups = got["groups"]
    assert list(groups) == ["onehot_lookup_bwd", "dense_tower_fwd",
                            "unattributed", "sort"]
    assert groups["onehot_lookup_bwd"]["us_per_step"] == pytest.approx(0.025)
    assert sum(g["share_of_op_time"] for g in groups.values()) == (
        pytest.approx(1.0))


def test_summarize_refuses_command_buffer_time():
    """A CUDA graph shows as one opaque event: the split would read 0."""
    events = [(0, 900, "command_buffer.3"), (900, 100, "fus.2")]
    with pytest.raises(RuntimeError, match="command-buffer"):
        ts.summarize(events, _names(), steps=1)


def test_summarize_refuses_a_trace_without_tower_ops():
    with pytest.raises(RuntimeError, match="dense_tower"):
        ts.summarize([(0, 50, "fus.1"), (50, 10, "fus.3")], _names(), steps=1)
    with pytest.raises(RuntimeError, match="no GPU stream events"):
        ts.summarize([], _names(), steps=1)


def test_compiled_scan_step_names_both_scopes_forward_and_backward():
    """The groups the tool reports exist in the step XLA compiles: the
    one-hot lookup and the tower, each forward and backward."""
    import jax.numpy as jnp
    import optax

    from deepctr_tpu.data import ipinyou_like_schema, synthetic
    from deepctr_tpu.models import MlpSpec, make_fnn
    from deepctr_tpu.ops.split_embed import make_split_plan
    from deepctr_tpu.optim import SparseAdagrad
    from deepctr_tpu.train import init_state
    from deepctr_tpu.train.step import make_scan_train_step

    schema = ipinyou_like_schema()
    split = make_split_plan(schema, threshold=64)
    assert split.has_small and split.big_slots
    T, B = 2, 32
    ds = synthetic.generate(schema, num_examples=T * B, k=2, seed=5)
    model = make_fnn(schema, k=4, mlp=MlpSpec(hidden=(8, 8), dropout=0.5))
    sopt, dopt = SparseAdagrad(0.05), optax.adagrad(0.02)
    state = init_state(model, schema, sopt, dopt, seed=0, table_dtype="bf16")
    step = make_scan_train_step(model, schema, sopt, dopt, split=split)
    hlo = step.lower(
        state, jnp.asarray(ds.ids).reshape(T, B, -1),
        jnp.asarray(ds.labels).reshape(T, B), jnp.ones((T, B), jnp.float32),
    ).compile(compiler_options=ts.NO_COMMAND_BUFFER).as_text()
    groups = {ts.op_group(n) for n in ts.op_names_from_hlo(hlo).values()}
    assert {"onehot_lookup_fwd", "onehot_lookup_bwd", "dense_tower_fwd",
            "dense_tower_bwd", "scatter", "sort"} <= groups
