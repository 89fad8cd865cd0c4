"""Port codes/ vs the JAX package's codes/ (host numpy, array-equal)."""

import filecmp
import os

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu_torch.codes import get_code

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

PACKAGED = ("ccsds_128_64", "array_121_60", "array_121_80", "qc_96_48",
            "code1_64_32", "wimax_1056_880", "wimaxlike_384_192")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", PACKAGED)
def test_code_matches_jax(name):
    ref, got = jax_get_code(name), get_code(name)
    np.testing.assert_array_equal(got.h, ref.h)
    np.testing.assert_array_equal(got.g, ref.g)
    np.testing.assert_array_equal(got.h_osd, ref.h_osd)
    assert (got.n, got.k, got.m, got.rate) == (ref.n, ref.k, ref.m, ref.rate)
    np.testing.assert_array_equal(got.extended().h, ref.extended().h)


@pytest.mark.parametrize("name", PACKAGED)
def test_packaged_data_is_byte_equal(name):
    a = os.path.join(_ROOT, "short_ldpc_decoding_osd_tpu", "data", name + ".npz")
    b = os.path.join(_ROOT, "short_ldpc_decoding_osd_tpu_torch", "data",
                     name + ".npz")
    assert filecmp.cmp(a, b, shallow=False)
