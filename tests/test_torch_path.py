"""Port ``osd/path.py`` (MRB error patterns, the pattern counter and the
decoding path) against the JAX package's, and against the two committed
``decoding_path.json`` oracles."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.osd import path as jpath
from short_ldpc_decoding_osd_tpu_torch.osd import path

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _failures():
    blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
    return blob["llr"], blob["labels"]


def _noisy(code, b, seed):
    rng = np.random.default_rng(seed)
    words = (rng.integers(0, 2, (b, code.k)) @ code.g % 2).astype(np.int32)
    noise = rng.normal(1.0, 1.0, (b, code.n))
    return np.where(words == 0, noise, -noise).astype(np.float32), words


@pytest.mark.parametrize("name,raw", [("ccsds_128_64", False),
                                      ("array_121_60", True),
                                      ("wimaxlike_384_192", False)])
def test_mrb_error_patterns_match_jax(name, raw):
    """Patterns and swap_len equal JAX's: CCSDS on the committed failure
    set (``runs/refparity/failures.npz``), the rank-deficient raw H of
    array_121_60 and the 192-row wimaxlike code on noisy frames."""
    code = jax_get_code(name)
    if name == "ccsds_128_64":
        llr, labels = _failures()
    else:
        llr, labels = _noisy(code, 12, 3)
    h = code.h if raw else code.h_osd
    k = code.n - h.shape[0]
    want_p, want_s = jpath.mrb_error_patterns(jnp.asarray(llr),
                                              jnp.asarray(labels),
                                              jnp.asarray(h), k)
    got_p, got_s = path.mrb_error_patterns(torch.as_tensor(llr),
                                           torch.as_tensor(labels), h, k)
    assert got_p.dtype == torch.int32 and got_p.shape == (len(llr), 6)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if name == "ccsds_128_64":
        assert got_p.numpy().any()  # failures carry MRB errors


def test_mrb_bit_error_histogram_matches_jax():
    llr, labels = _failures()
    for k in (64, 40):
        want = jpath.mrb_bit_error_histogram(jnp.asarray(llr),
                                             jnp.asarray(labels), k)
        got = path.mrb_bit_error_histogram(torch.as_tensor(llr),
                                           torch.as_tensor(labels), k)
        assert got == want and sum(got.values()) == len(llr)


def test_pattern_counter_matches_jax_and_round_trips(tmp_path):
    """Counts, ratios and the ranked path (ties included) equal JAX's
    counter fed the same patterns; save then load gives the same counter."""
    rng = np.random.default_rng(5)
    patterns = rng.integers(0, 3, (400, 6)) * (rng.uniform(size=(400, 6)) < 0.3)
    swap_len = rng.integers(0, 5, 400)
    pc, ref = path.PatternCounter(64), jpath.PatternCounter(64)
    for lo in range(0, 400, 100):
        pc.update(torch.as_tensor(patterns[lo:lo + 100]),
                  torch.as_tensor(swap_len[lo:lo + 100]))
        ref.update(patterns[lo:lo + 100], swap_len[lo:lo + 100])
    assert pc.counts == ref.counts and pc.total == ref.total == 400
    assert pc.swap_sum == ref.swap_sum
    assert pc.ratio_normalized() == ref.ratio_normalized()
    for thr, length in ((3, 30), (2, 16), (6, 100)):
        assert pc.decoding_path(thr, length) == ref.decoding_path(thr, length)
    pc.save(str(tmp_path / "counts.json"))
    back = path.PatternCounter.load(str(tmp_path / "counts.json"))
    assert (back.k, back.num_segments, back.total, back.swap_sum) == (
        64, 6, 400, pc.swap_sum)
    assert back.counts == pc.counts
    assert list(back.counts) == list(pc.counts)  # key order kept
    assert back.decoding_path(3, 30) == pc.decoding_path(3, 30)


# run directory -> patterns of its committed decoding path
PATH_LENGTHS = {"r4_pipeline": 30,
                os.path.join("r5_multicode", "wimax_1056_880"): 15,
                **{os.path.join("r5_multicode", name): 30
                   for name in ("qc_96_48", "array_121_60", "regular_256_128",
                                "wimaxlike_384_192")}}


@pytest.mark.parametrize("run", list(PATH_LENGTHS))
def test_decoding_path_oracle(run):
    """``PatternCounter.load`` of a run's ``pattern_counts.json`` and
    ``decoding_path`` at the run's ``threshold_sum`` / ``decoding_length``
    give the run's committed ``decoding_path.json`` (r4_pipeline and the
    four rate-1/2 multi-code runs: (3, 30), 30 patterns; WiMAX: (2, 16),
    15 patterns)."""
    run_dir = os.path.join(_ROOT, "runs", run)
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(run_dir, "decoding_path.json")) as fh:
        want = json.load(fh)["path"]
    pc = path.PatternCounter.load(os.path.join(run_dir, "pattern_counts.json"))
    got = pc.decoding_path(cfg["threshold_sum"], cfg["decoding_length"])
    assert got == want
    assert len(got) == PATH_LENGTHS[run]
