"""The port's ``baselines/fs_osd.py`` vs the JAX package (CPU) on the 256
CCSDS frames of ``runs/refparity/base_failures.npz``, in both
``score_tau_e_codeword`` modes: every output field exact, and the success
flags, TEP counts and stop kinds equal to the JAX package's record."""

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu.baselines import fs_osd as jfs
from short_ldpc_decoding_osd_tpu_torch.baselines import fs_osd

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from torch_baselines_common import (assert_outputs_equal, ccsds_codes, jax_args,
                                    jax_np, port_np, refparity)


@pytest.fixture(scope="module")
def refparity_runs():
    code, jcode = ccsds_codes()
    blob = refparity()
    runs = {}
    for mode in (True, False):
        kw = dict(order_limit=3, beta=0.1, d_min=14, tau_psc=30,
                  score_tau_e_codeword=mode)
        runs[mode] = (
            port_np(fs_osd.fs_osd(blob["llr"], blob["labels"], code.g, code.k,
                                  device="cpu", **kw)),
            jax_np(jfs.fs_osd(*jax_args(blob["llr"], blob["labels"]), jcode.g,
                              jcode.k, **kw)))
    return blob, runs


@pytest.mark.parametrize("mode", [True, False], ids=["intended", "literal"])
def test_fs_osd_refparity_matches_jax(refparity_runs, mode):
    _, runs = refparity_runs
    got, want = runs[mode]
    assert_outputs_equal(got, want, mode)


@pytest.mark.parametrize("mode", [True, False], ids=["intended", "literal"])
def test_fs_osd_refparity_matches_record(refparity_runs, mode):
    """Success and TEP counts equal ``base_failures.npz`` (a TPU run of the
    JAX package), frame by frame; the stop kind too."""
    blob, runs = refparity_runs
    got, _ = runs[mode]
    tag = "intended" if mode else "literal"
    np.testing.assert_array_equal(got["success"], blob[f"fs_success_{tag}"])
    np.testing.assert_array_equal(
        got["num_teps"], blob["fs_num_teps" if mode else "fs_num_teps_literal"])
    if mode:
        stop = np.where(got["zero_stop"], 0, np.where(
            got["tau_e_stop"], 1, np.where(got["gate_stop"], 2, 3)))
        np.testing.assert_array_equal(stop, blob["fs_stop"])
    assert int(got["success"].sum()) == 255
    assert float(got["num_teps"].mean()) == 1176.875
