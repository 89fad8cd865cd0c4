"""The port's ``engine.pruned_batch_osd`` vs the JAX package (CPU).

Inputs: a seeded CCSDS batch whose updated metric differs from the
original one (so the pruning's ``e0`` must use the updated hard decision),
and the 96 rows of ``runs/refparity/failures.npz`` with updated = original
= ``llr``, each prepared by its own package's ``engine.prepare``, scored
on ``runs/r4_pipeline``'s 1,439 decoding-path TEPs (30 blocks, 6 segments).

Tolerances: ``success`` and ``num_candidates`` (the pruning mask's row
sums) are integer or 0/1 arithmetic and must be equal; ``min_discrepancy`` 1e-5
relative (the port sums the parity term in another order, K5's on the
card); ``best_index`` equal wherever the two smallest discrepancies differ
by more than 1e-5 relative (elsewhere either index of the tie may win).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.osd import engine, experimental

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = get_code("ccsds_128_64")
K = CODE.k
TIE_RTOL = 1e-5


@pytest.fixture(scope="module")
def path_teps():
    with open(os.path.join(_ROOT, "runs", "r4_pipeline", "decoding_path.json")) as fh:
        path = json.load(fh)["path"]
    blocks, _ = jseg.build_tep_blocks(path, K, 6)
    teps = np.concatenate(blocks).astype(np.int8)
    assert teps.shape == (1439, K)
    return teps


def _seeded(b, seed):
    rng = np.random.default_rng(seed)
    words = (rng.integers(0, 2, (b, K)) @ CODE.g % 2).astype(np.int32)
    original = (np.where(words == 0, 1.0, -1.0)
                + rng.normal(0, 0.9, (b, CODE.n))).astype(np.float32)
    updated = (original * rng.uniform(0.6, 1.4, (b, CODE.n))).astype(np.float32)
    return updated, original, words


def _refparity():
    blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
    return blob["llr"], blob["llr"], blob["labels"]


def _preps(updated, original, labels):
    jprep = jengine.prepare(jnp.asarray(updated), jnp.asarray(original),
                            jnp.asarray(labels), jnp.asarray(CODE.h_osd), K)
    prep = engine.prepare(torch.as_tensor(updated), torch.as_tensor(original),
                          torch.as_tensor(labels), CODE.h_osd, K)
    return jprep, prep


@pytest.fixture(scope="module")
def batches():
    return {"seeded": _preps(*_seeded(48, seed=3)), "refparity": _preps(*_refparity())}


def _tie_free(prep, teps, keep=None):
    """Frames whose two smallest (masked) port discrepancies differ by more
    than TIE_RTOL relative."""
    disc = engine._tep_discrepancies(prep, teps, K)
    if keep is not None:
        disc = torch.where(keep, disc, engine._BIG)
    two = torch.topk(disc, 2, dim=1, largest=False).values
    return ((two[:, 1] - two[:, 0]) > TIE_RTOL * two[:, 0].abs().clamp(min=1.0)).numpy()


def _assert_matches_jax(jprep, prep, teps, threshold_sum, prune):
    want = jengine.pruned_batch_osd(jprep, jnp.asarray(teps), K,
                                    threshold_sum=threshold_sum, prune=prune)
    want = {key: np.asarray(v) for key, v in want.items()}
    t = torch.as_tensor(teps)
    got = {key: v.numpy() for key, v in engine.pruned_batch_osd(
        prep, t, K, threshold_sum=threshold_sum, prune=prune).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["success"], want["success"])
    np.testing.assert_array_equal(got["num_candidates"], want["num_candidates"])
    np.testing.assert_allclose(got["min_discrepancy"], want["min_discrepancy"],
                               rtol=1e-5)
    keep = engine._prune_keep(prep, t, threshold_sum)[0] if prune else None
    clear = _tie_free(prep, t, keep)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["best_index"][clear], want["best_index"][clear])
    return got


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("threshold_sum", [1, 3])
@pytest.mark.parametrize("data", ["seeded", "refparity"])
def test_pruned_batch_osd_matches_jax(batches, path_teps, data, threshold_sum,
                                      prune):
    jprep, prep = batches[data]
    got = _assert_matches_jax(jprep, prep, path_teps, threshold_sum, prune)
    if not prune:
        assert (got["num_candidates"] == path_teps.shape[0]).all()


def test_first_four_fallback_matches_jax(path_teps):
    """An updated metric unrelated to the channel, ``threshold_sum`` 0 and
    the path's first 8 TEPs: frames keep fewer than 2 TEPs, so the
    reference's quirk keeps the first 4."""
    updated, original, words = _seeded(32, seed=5)
    updated = np.random.default_rng(6).normal(0, 1, updated.shape).astype(np.float32)
    jprep, prep = _preps(updated, original, words)
    teps = path_teps[:8]
    keep, fell = engine._prune_keep(prep, torch.as_tensor(teps), 0)
    assert int(fell.sum()) > 0
    assert (keep[fell] == (torch.arange(8) < 4)).all()
    got = _assert_matches_jax(jprep, prep, teps, 0, True)
    np.testing.assert_array_equal(got["num_candidates"][fell.numpy()], 4)
    assert (got["best_index"][fell.numpy()] < 4).all()


def test_pruning_only_removes_candidates(batches, path_teps):
    """The JAX test's properties (``tests/test_aux.py``) on the port: the
    pruned set is a subset, so its minimum is no smaller."""
    _, prep = batches["seeded"]
    t = torch.as_tensor(path_teps)
    full = engine.pruned_batch_osd(prep, t, K, prune=False)
    pruned = engine.pruned_batch_osd(prep, t, K, prune=True)
    assert (pruned["num_candidates"] <= full["num_candidates"]).all()
    assert (full["min_discrepancy"] <= pruned["min_discrepancy"]).all()


def test_success_is_the_argmin_candidate(batches, path_teps):
    """``success`` is the strict test of the selected candidate: the row of
    ``candidate_matrix`` at ``best_index`` equals the transmitted word, and
    the unpruned count equals ``best_estimation_counts``."""
    _, prep = batches["refparity"]
    t = torch.as_tensor(path_teps)
    out = engine.pruned_batch_osd(prep, t, K, prune=False)
    cand = experimental.candidate_matrix(prep, t, K)
    sel = cand[torch.arange(cand.shape[0]), out["best_index"]]
    np.testing.assert_array_equal(
        (sel == prep.order_labels.to(torch.float32)).all(1).numpy(),
        out["success"].numpy())
    correct, failed = experimental.best_estimation_counts(prep, t, K)
    assert correct == int(out["success"].sum())
    assert correct + failed == cand.shape[0]


def test_noiseless_frames_all_succeed(path_teps):
    """Noiseless frames: TEP 0 is the codeword, at discrepancy 0."""
    _, _, words = _seeded(8, seed=2)
    llr = (1.0 - 2.0 * words).astype(np.float32)
    _, prep = _preps(llr, llr, words)
    for prune in (False, True):
        out = engine.pruned_batch_osd(prep, torch.as_tensor(path_teps), K,
                                      prune=prune)
        assert out["success"].all()
        assert (out["best_index"] == 0).all()
        assert (out["min_discrepancy"] == 0).all()
