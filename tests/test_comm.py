"""Comm-volume accounting (parallel/comm.py): per-step exchanged bytes of
the sharded step.

The capacity formula is IMPORTED by the sharded step, so the accounting and
execution cannot drift; these tests pin the volume algebra that SCALING.md
publishes.
"""

import numpy as np

from deepctr_tpu.data import ipinyou_like_schema
from deepctr_tpu.ops.split_embed import make_split_plan
from deepctr_tpu.parallel import comm_volume, exchange_capacity


def test_exchange_capacity_properties():
    # matches the historical inline formula of the sharded step
    def old(m, n, cf):
        cdiv = lambda a, b: -(-a // b)
        return max(1, min(max(m, 1), int(cf * cdiv(max(m, 1), n))))

    for m in (0, 1, 7, 64, 8192 * 2, 8192 * 18):
        for n in (1, 2, 4, 8):
            for cf in (0.5, 1.0, 2.0, 8.0):
                assert exchange_capacity(m, n, cf) == old(m, n, cf)


def test_comm_volume_algebra():
    schema = ipinyou_like_schema()
    split = make_split_plan(schema)
    v = comm_volume(schema, batch_per_device=8192, n_devices=8,
                    capacity_factor=2.0, split=split, dense_param_bytes=500_000)
    # the two row exchanges carry D floats per id slot
    assert v.rows_a2a_fwd == v.rows_a2a_bwd == v.ids_a2a * 11
    # capacity doubles -> a2a volumes double (below the m cap)
    v2 = comm_volume(schema, batch_per_device=8192, n_devices=8,
                     capacity_factor=4.0, split=split,
                     dense_param_bytes=500_000)
    assert v2.ids_a2a == 2 * v.ids_a2a
    assert v2.small_allgather == v.small_allgather  # cf does not touch small
    # split removes most of the exchange: all-exchange >> split exchange
    v_all = comm_volume(schema, batch_per_device=8192, n_devices=8,
                        capacity_factor=2.0, split=None,
                        dense_param_bytes=500_000)
    assert v_all.ids_a2a > 5 * v.ids_a2a  # 18 slots vs the few big ones
    # wire fractions: psum moves 2(n-1)/n of operand, a2a (n-1)/n of payload
    n = 8
    assert v.psum_wire == int((v.small_psum + v.dense_psum) * 2 * (n - 1) / n)
    assert v.a2a_wire == int(
        (v.ids_a2a + v.rows_a2a_fwd + v.rows_a2a_bwd) * (n - 1) / n
    )
