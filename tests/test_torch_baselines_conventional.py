"""The port's ``baselines/conventional.py`` vs the JAX package (CPU):
``conventional_osd`` (success, best index, phase, TEP count) and the
miracle view's histogram exact on the small code of
``tests/test_baselines.py`` and on the 256 CCSDS frames of
``runs/refparity/base_failures.npz``; ports of JAX's single-error and
large-k tests."""

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu.baselines import conventional as jconv
from short_ldpc_decoding_osd_tpu_torch import baselines
from short_ldpc_decoding_osd_tpu_torch.baselines import conventional, fs_osd, pb_osd
from short_ldpc_decoding_osd_tpu_torch.codes import get_code

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from torch_baselines_common import (assert_outputs_equal, ccsds_codes, jax_args,
                                    jax_np, noisy_batch, port_np, refparity,
                                    small_codes)


def test_exports_match_jax():
    from short_ldpc_decoding_osd_tpu import baselines as jbaselines

    assert baselines.__all__ == jbaselines.__all__
    assert baselines.run_fs_osd is fs_osd.fs_osd
    assert baselines.run_pb_osd is pb_osd.pb_osd


@pytest.mark.parametrize("k,order", [(24, 2), (64, 3), (12, 0)])
def test_full_tep_matrix_matches_jax(k, order):
    teps, bounds = conventional.full_tep_matrix(k, order)
    jteps, jbounds = jconv.full_tep_matrix(k, order)
    np.testing.assert_array_equal(teps, jteps)
    np.testing.assert_array_equal(bounds, jbounds)


def _inputs(name):
    if name == "small":
        code, jcode = small_codes()
        llr, words = noisy_batch(code, 32, 1.5, 6)
        return code, jcode, llr, words, 2
    code, jcode = ccsds_codes()
    blob = refparity()
    return code, jcode, blob["llr"], blob["labels"], 3


@pytest.mark.parametrize("name", ["small", "refparity"])
def test_conventional_osd_matches_jax(name):
    code, jcode, llr, words, order = _inputs(name)
    got = port_np(conventional.conventional_osd(llr, words, code.g, code.k,
                                                order_limit=order, device="cpu"))
    want = jax_np(jconv.conventional_osd(*jax_args(llr, words), jcode.g, jcode.k,
                                         order_limit=order))
    assert_outputs_equal(got, want, name)
    if name == "refparity":  # runs/r5_baselines' 3.0 dB point: 256 of 256
        assert int(got["success"].sum()) == 256
        assert int(got["num_teps"]) == 43745


@pytest.mark.parametrize("name", ["small", "refparity"])
def test_miracle_view_matches_jax(name):
    code, jcode, llr, words, _ = _inputs(name)
    got = conventional.miracle_view(llr, words, code.g, code.k, device="cpu")
    want = jconv.miracle_view(*jax_args(llr, words), jcode.g, jcode.k)
    assert got == want
    assert sum(got.values()) == len(llr)
    for order in range(4):
        assert (conventional.miracle_fer_floor(got, order)
                == jconv.miracle_fer_floor(want, order))
    floor0 = conventional.miracle_fer_floor(got, 0)
    assert 0.0 <= conventional.miracle_fer_floor(got, 2) <= floor0 <= 1.0


def test_conventional_osd_order1_perfect_on_single_error():
    """Port of JAX's test: on clean CCSDS frames order 1 succeeds and the
    zero TEP wins."""
    code = get_code("ccsds_128_64")
    rng = np.random.default_rng(4)
    words = code.encode(rng.integers(0, 2, (8, code.k)))
    llr = np.where(words == 0, 2.0, -2.0).astype(np.float32)
    llr += rng.normal(0, 0.05, llr.shape).astype(np.float32)
    out = port_np(conventional.conventional_osd(llr, words, code.g, code.k,
                                                order_limit=1, device="cpu"))
    assert out["success"].all()
    assert (out["phase"] == 0).all()


def test_chunk_changes_nothing():
    code, _, llr, words, order = _inputs("small")
    outs = [port_np(conventional.conventional_osd(
        llr, words, code.g, code.k, order_limit=order, chunk=chunk, device="cpu"))
        for chunk in (7, 2048)]
    assert_outputs_equal(outs[0], outs[1])


def test_large_k_tep_sets_rejected_with_guidance():
    """Port of JAX's test: C(880, 3) ~ 113M TEP rows; the full-enumeration
    baselines fail fast with a pointer to the learned path."""
    with pytest.raises(ValueError, match="impractical"):
        pb_osd.weight_limited_teps(880, 3)
    with pytest.raises(ValueError, match="impractical"):
        fs_osd.sequential_tep_matrix(880, 3)
    with pytest.raises(ValueError, match="impractical"):
        conventional.full_tep_matrix(880, 3)
