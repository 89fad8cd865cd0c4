"""The port's ``baselines/pb_osd.py`` vs the JAX package (CPU) on the 256
CCSDS frames of ``runs/refparity/base_failures.npz``: every output field
exact, and the PB oracle: JAX run live on the CPU, not the ``.npz``'s PB
cost fields, which are a TPU record."""

import json
import os

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu.baselines import pb_osd as jpb
from short_ldpc_decoding_osd_tpu_torch.baselines import pb_osd

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from torch_baselines_common import (PB_RECORD_DIFF_FRAMES, REFPARITY,
                                    assert_outputs_equal, ccsds_codes, jax_args,
                                    jax_np, port_np, refparity)


@pytest.fixture(scope="module")
def refparity_runs():
    code, jcode = ccsds_codes()
    blob = refparity()
    snr = float(blob["osd_snr"])
    got = port_np(pb_osd.pb_osd(blob["llr"], blob["labels"], code.g, code.k,
                                snr_db=snr, device="cpu"))
    want = jax_np(jpb.pb_osd(*jax_args(blob["llr"], blob["labels"]), jcode.g,
                             jcode.k, snr_db=snr))
    return blob, got, want


def test_pb_osd_refparity_matches_jax(refparity_runs):
    _, got, want = refparity_runs
    assert_outputs_equal(got, want, "refparity")


def test_pb_oracle_is_jax_live_not_the_record(refparity_runs):
    """JAX on the CPU (and so the port) differs from the ``.npz``'s PB cost
    fields at exactly frames 36, 126, 128, 145 and 194, equals
    ``ref_base_pb.json``'s (the reference's) cost at the first four, and
    equals the record's success, improvement and stop fields everywhere."""
    blob, got, want = refparity_runs
    for out in (want, got):
        for field, rec in (("num_teps", "pb_cost"), ("maintained_list",
                                                     "pb_maintained"),
                           ("suc_evals", "pb_suc_evals")):
            diff = np.flatnonzero(out[field] != blob[rec]).tolist()
            assert diff == PB_RECORD_DIFF_FRAMES, (field, diff)
        np.testing.assert_array_equal(out["success"], blob["pb_success"])
        np.testing.assert_array_equal(out["improvements"], blob["pb_improvements"])
        stop = np.where(out["stopped_by_suc"], 1,
                        np.where(out["stopped_by_pro"], 2, 0))
        np.testing.assert_array_equal(stop, blob["pb_stop"])
        assert int(out["n_max"]) == int(blob["pb_n_max"])
    with open(os.path.join(REFPARITY, "ref_base_pb.json")) as fh:
        ref_cost = json.load(fh)["pb"]["cost"]
    for frame in PB_RECORD_DIFF_FRAMES[:4]:
        assert int(got["num_teps"][frame]) == ref_cost[frame], frame
    # frame 194: the reference caps its walk at 4,096 TEPs
    assert ref_cost[194] == 4096 < int(got["num_teps"][194])
