"""The port's ``baselines/fs_osd.py`` vs the JAX package (CPU), in both
``score_tau_e_codeword`` modes: every output field exact on the small code
of ``tests/test_baselines.py``; its static tables and prefix scans; ports
of JAX's golden and scoring-mode tests.  The 256 CCSDS parity frames are
``tests/test_torch_baselines_fs_refparity.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.baselines import fs_osd as jfs
from short_ldpc_decoding_osd_tpu_torch.baselines import fs_osd

import golden_baselines as gb
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from torch_baselines_common import (assert_outputs_equal, jax_args, jax_np,
                                    noisy_batch, port_np, small_codes)

# (batch, snr, seed, order_limit, d_min, tau_psc): the setting of
# tests/test_baselines.py's FS golden test, and an order-3 run
SMALL_CASES = [(24, 1.5, 2, 2, 5, 10), (32, 2.5, 13, 3, 7, 30)]


def test_tep_matrix_and_bounds_match_jax():
    teps, starts = fs_osd.sequential_tep_matrix(24, 3)
    jteps, jstarts = jfs.sequential_tep_matrix(24, 3)
    np.testing.assert_array_equal(teps, jteps)
    np.testing.assert_array_equal(starts, jstarts)
    x = np.random.default_rng(0).normal(0, 2, (5, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        fs_osd.pnc_bounds(torch.as_tensor(x), 24, 3).numpy(),
        np.asarray(jfs.pnc_bounds(jnp.asarray(x), 24, 3)))
    init = torch.as_tensor(x[:, 0])
    got = fs_osd._exclusive_cummin(torch.as_tensor(x), init).numpy()
    want = np.minimum(np.concatenate([np.full((5, 1), np.inf),
                                      np.minimum.accumulate(x, 1)[:, :-1]], 1),
                      x[:, :1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", SMALL_CASES, ids=lambda c: f"seed{c[2]}")
@pytest.mark.parametrize("mode", [True, False], ids=["intended", "literal"])
def test_fs_osd_small_code_matches_jax(case, mode):
    batch, snr, seed, order, d_min, tau_psc = case
    code, jcode = small_codes()
    llr, words = noisy_batch(code, batch, snr, seed)
    kw = dict(order_limit=order, beta=0.1, d_min=d_min, tau_psc=tau_psc,
              score_tau_e_codeword=mode)
    got = port_np(fs_osd.fs_osd(llr, words, code.g, code.k, device="cpu", **kw))
    want = jax_np(jfs.fs_osd(*jax_args(llr, words), jcode.g, jcode.k, chunk=128,
                             **kw))
    assert_outputs_equal(got, want, (case, mode))


def test_fs_osd_matches_golden():
    """Port of ``test_fs_osd_matches_golden``: the serial FS walk."""
    code, _ = small_codes()
    llr, words = noisy_batch(code, 24, 1.5, 2)
    order_limit, beta, tau_psc, tau_e = 2, 0.1, 10, 2.0
    out = port_np(fs_osd.fs_osd(llr, words, code.g, code.k,
                                order_limit=order_limit, beta=beta,
                                d_min=int(2 * tau_e + 1), tau_psc=tau_psc,
                                device="cpu"))
    teps, starts = fs_osd.sequential_tep_matrix(code.k, order_limit)
    for i in range(24):
        in_ref, lab_ref, p_ref = gb.host_prepare_g(llr[i], words[i], code.g, code.k)
        ok_ref, num_ref = gb.fs_golden(in_ref, lab_ref, p_ref, code.k, teps,
                                       starts, order_limit, beta, tau_e, tau_psc)
        assert bool(out["success"][i]) == bool(ok_ref), i
        assert int(out["num_teps"][i]) == num_ref, i


def test_fs_literal_vs_intended_tau_e_scoring():
    """Port of ``test_fs_literal_vs_intended_tau_e_scoring``: counting is
    the same in both modes, scoring differs only on tau_e stops."""
    code, _ = small_codes()
    llr, words = noisy_batch(code, 32, 1.0, 12)
    kw = dict(order_limit=2, beta=0.1, d_min=5, tau_psc=10, device="cpu")
    out_i = port_np(fs_osd.fs_osd(llr, words, code.g, code.k,
                                  score_tau_e_codeword=True, **kw))
    out_l = port_np(fs_osd.fs_osd(llr, words, code.g, code.k,
                                  score_tau_e_codeword=False, **kw))
    np.testing.assert_array_equal(out_i["num_teps"], out_l["num_teps"])
    diff = out_i["success"] != out_l["success"]
    assert not np.any(diff & ~out_i["tau_e_stop"])


def test_chunk_changes_nothing():
    code, _ = small_codes()
    llr, words = noisy_batch(code, 16, 1.5, 4)
    outs = [port_np(fs_osd.fs_osd(llr, words, code.g, code.k, order_limit=2,
                                  d_min=5, tau_psc=10, chunk=chunk, device="cpu"))
            for chunk in (1, 128, 2048)]
    for out in outs[1:]:
        assert_outputs_equal(out, outs[0])
