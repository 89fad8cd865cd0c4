"""The port's ``baselines/pb_osd.py`` vs the JAX package (CPU): every output
field exact on the small code of ``tests/test_baselines.py``; its static
tables; ports of JAX's golden and queue tests.  The 256 CCSDS parity
frames and the PB oracle are ``tests/test_torch_baselines_pb_refparity.py``'s.
"""

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu.baselines import pb_osd as jpb
from short_ldpc_decoding_osd_tpu.codes import make_regular_ldpc as jax_make_regular_ldpc
from short_ldpc_decoding_osd_tpu_torch.baselines import pb_osd
from short_ldpc_decoding_osd_tpu_torch.codes import make_regular_ldpc

import golden_baselines as gb
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from torch_baselines_common import (assert_outputs_equal, jax_args, jax_np,
                                    noisy_batch, port_np, small_codes)


def test_static_tables_match_jax():
    for k, order in ((12, 3), (24, 2), (64, 3)):
        teps = pb_osd.weight_limited_teps(k, order)
        np.testing.assert_array_equal(teps, jpb.weight_limited_teps(k, order))
        np.testing.assert_array_equal(pb_osd._tep_push_counts(teps, k, order),
                                      jpb._tep_push_counts(teps, k, order))
    for n in (24, 64):
        np.testing.assert_array_equal(pb_osd._log_binom_table(n),
                                      jpb._log_binom_table(n))


@pytest.mark.parametrize("case", [(16, 1.5, 3, 2), (32, 2.0, 21, 3)],
                         ids=lambda c: f"seed{c[2]}")
def test_pb_osd_small_code_matches_jax(case):
    batch, snr, seed, order = case
    code, jcode = small_codes()
    llr, words = noisy_batch(code, batch, snr, seed)
    got = port_np(pb_osd.pb_osd(llr, words, code.g, code.k, snr_db=snr,
                                order_limit=order, device="cpu"))
    want = jax_np(jpb.pb_osd(*jax_args(llr, words), jcode.g, jcode.k, snr_db=snr,
                             order_limit=order, chunk=128))
    assert_outputs_equal(got, want, case)


def test_pb_osd_matches_golden():
    """Port of ``test_pb_osd_matches_golden``: the serial PB walk."""
    code, _ = small_codes()
    llr, words = noisy_batch(code, 16, 1.5, 3)
    out = port_np(pb_osd.pb_osd(llr, words, code.g, code.k, snr_db=1.5,
                                order_limit=2, device="cpu"))
    teps = pb_osd.weight_limited_teps(code.k, 2)
    for i in range(16):
        in_ref, lab_ref, p_ref = gb.host_prepare_g(llr[i], words[i], code.g, code.k)
        ok_ref, cost_ref = gb.pb_golden(in_ref, lab_ref, p_ref, code.k, teps,
                                        1.5, 2)
        assert bool(out["success"][i]) == bool(ok_ref), i
        assert int(out["num_teps"][i]) == cost_ref, i


def test_pb_pop_order_matches_dynamic_queue():
    """Port of JAX's test: the static ascending-reliability visiting order
    (here ``torch.sort(stable=True)``) IS the reference's dynamic
    priority-queue pop order, and the maintained-list comparison counters
    follow the static successor tree."""
    import torch

    k, order_limit = 12, 3
    rng = np.random.default_rng(11)
    mag = np.sort(rng.uniform(0.05, 3.0, k))[::-1].copy()  # descending MRB
    teps = pb_osd.weight_limited_teps(k, order_limit)
    n_teps = len(teps)
    rels = torch.as_tensor(teps, dtype=torch.float32) @ torch.as_tensor(
        mag, dtype=torch.float32)
    static_order = torch.sort(rels, stable=True).indices.numpy()
    popped, counters, _ = gb.pb_queue_golden(mag, order_limit, n_teps)
    assert popped == [tuple(np.nonzero(teps[i])[0]) for i in static_order]
    pushes = pb_osd._tep_push_counts(teps, k, order_limit)[static_order]
    size_before = 1 + np.cumsum(pushes) - pushes - np.arange(n_teps)
    assert list(np.where(size_before <= 1, 1, 2)) == counters
    assert size_before[-1] == 1  # the queue drains exactly at the last pop


def test_pb_maintained_list_metric_matches_queue():
    """Port of JAX's test: ``maintained_list`` equals the dynamic-queue
    accounting truncated at the stop (``pb_testing.py:120-122,166``)."""
    code = make_regular_ldpc(32, 16, row_weight=4, seed=5)
    assert np.array_equal(code.g, jax_make_regular_ldpc(32, 16, row_weight=4,
                                                        seed=5).g)
    llr, words = noisy_batch(code, 8, 1.5, 7)
    out = port_np(pb_osd.pb_osd(llr, words, code.g, code.k, snr_db=1.5,
                                order_limit=2, chunk=64, device="cpu"))
    n_max = 1 + len(pb_osd.weight_limited_teps(code.k, 2))
    for i in range(8):
        in_ref, _, _ = gb.host_prepare_g(llr[i], words[i], code.g, code.k)
        cost = int(out["num_teps"][i])
        pops = cost if cost < n_max else n_max - 1
        _, counters, _ = gb.pb_queue_golden(np.abs(in_ref[:code.k]), 2, pops)
        assert int(out["maintained_list"][i]) == sum(counters), i
