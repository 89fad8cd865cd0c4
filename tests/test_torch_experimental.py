"""The port's ``osd/experimental.py`` vs the JAX package (CPU).

Every function is integer, 0/1 or permutation arithmetic (the weighted
sums of ``best_estimation_counts`` only choose an argmin, and the inputs
have no near-ties), so each must equal JAX's exactly.  The JAX module's own
tests (``tests/test_osd_experimental.py``) are mirrored on the port.
"""

import json
import os
from math import comb

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import gf2 as jgf2
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import experimental as jexp
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.osd import engine, experimental
from short_ldpc_decoding_osd_tpu_torch.osd.segments import expand_pattern

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = get_code("ccsds_128_64")
K = CODE.k


def _frames(b, seed, sigma=0.7):
    rng = np.random.default_rng(seed)
    words = (rng.integers(0, 2, (b, K)) @ CODE.g % 2).astype(np.int32)
    rx = ((1 - 2 * words) + sigma * rng.standard_normal((b, CODE.n))).astype(np.float32)
    return rx, words


def _preps(updated, original, labels):
    jprep = jengine.prepare(jnp.asarray(updated), jnp.asarray(original),
                            jnp.asarray(labels), jnp.asarray(CODE.h, jnp.float32), K)
    prep = engine.prepare(torch.as_tensor(updated), torch.as_tensor(original),
                          torch.as_tensor(labels), CODE.h, K)
    return jprep, prep


@pytest.fixture(scope="module")
def preps():
    rx, words = _frames(24, seed=0)
    return _preps(rx, rx, words)


def _teps(seed=None):
    """TEP 0, the weight-1 TEPs of the last 5 MRB positions, and (with a
    seed) 40 random weight-2/3 rows."""
    rows = [np.zeros((1, K), np.int8),
            experimental.combination_block(K, K - 5, K, 1)]
    if seed is not None:
        rng = np.random.default_rng(seed)
        rand = np.zeros((40, K), np.int8)
        for r in rand:
            r[rng.choice(K, rng.integers(2, 4), replace=False)] = 1
        rows.append(rand)
    return np.concatenate(rows)


def _mre_inputs():
    h2 = np.array(CODE.h)
    h2[:, 1] = h2[:, 0]
    rng = np.random.default_rng(4)
    tall = rng.integers(0, 2, (20, 12))  # more rows than columns
    dup = rng.integers(0, 2, (10, 24))
    dup[:, 5] = dup[:, 2] ^ dup[:, 3]
    return {"ccsds_h": CODE.h, "ccsds_repeated_column": h2, "random_tall": tall,
            "random_dependent": dup, "qc_96_48": get_code("qc_96_48").h}


@pytest.mark.parametrize("name", list(_mre_inputs()))
def test_medium_row_echelon_matches_jax(name):
    mat = _mre_inputs()[name]
    red, dep = experimental.medium_row_echelon(mat)
    jred, jdep = jexp.medium_row_echelon(mat)
    np.testing.assert_array_equal(red, jred)
    assert red.dtype == jred.dtype
    assert dep == jdep


def test_medium_row_echelon_properties():
    red, dep = experimental.medium_row_echelon(CODE.h)
    assert not dep
    pivots = [np.nonzero(r)[0][0] for r in red if r.any()]
    assert all(a < b for a, b in zip(pivots, pivots[1:]))
    assert jgf2.rank(red) == jgf2.rank(CODE.h)
    _, dep2 = experimental.medium_row_echelon(_mre_inputs()["ccsds_repeated_column"])
    assert 1 in dep2


@pytest.mark.parametrize("n_s", [0, 1, 3, 64])
@pytest.mark.parametrize("h_name", ["h", "h_osd"])
def test_swap_statistics_matches_jax(n_s, h_name):
    rng = np.random.default_rng(1)
    updated = rng.normal(1.0, 0.8, (40, CODE.n)).astype(np.float32)
    h = getattr(CODE, h_name)
    hist, initial = experimental.swap_statistics(torch.as_tensor(updated), h, K,
                                                 n_s=n_s)
    jhist, jinitial = jexp.swap_statistics(jnp.asarray(updated),
                                           jnp.asarray(h, jnp.float32), K, n_s=n_s)
    assert hist == jhist
    assert all(type(key) is int for key in hist)
    np.testing.assert_array_equal(initial, jinitial)
    assert initial.dtype == jinitial.dtype


def test_swap_statistics_properties():
    rng = np.random.default_rng(1)
    updated = torch.as_tensor(rng.normal(1.0, 0.8, (16, CODE.n)), dtype=torch.float32)
    hist, initial = experimental.swap_statistics(updated, CODE.h, K, n_s=0)
    assert sum(hist.values()) == 16
    swap_lens = np.repeat(np.fromiter(hist.keys(), dtype=int),
                          np.fromiter(hist.values(), dtype=int))
    assert ((initial == -1) | (initial >= CODE.n - K)).all()
    assert (initial >= 0).sum() == (swap_lens > 0).sum()


def test_updated_mrb_indices_matches_jax():
    rng = np.random.default_rng(2)
    updated = rng.normal(0.8, 1.0, (32, CODE.n)).astype(np.float32)
    got = experimental.updated_mrb_indices(torch.as_tensor(updated), CODE.h_osd, K)
    want = np.asarray(jexp.updated_mrb_indices(jnp.asarray(updated),
                                               jnp.asarray(CODE.h_osd), K))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.shape == (32, K)


@pytest.mark.parametrize("args", [(10, 2, 7, 2), (10, 2, 7, 0), (64, 0, 64, 1),
                                  (64, 40, 64, 3), (12, 3, 5, 2)])
def test_combination_block_matches_jax(args):
    got = experimental.combination_block(*args)
    want = jexp.combination_block(*args)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int8


def test_combination_block_counts():
    blk = experimental.combination_block(10, 2, 7, 2)
    assert blk.shape == (comb(5, 2), 10)
    assert (blk.sum(axis=1) == 2).all()
    assert blk[:, :2].sum() == 0 and blk[:, 7:].sum() == 0
    zero = experimental.combination_block(10, 2, 7, 0)
    assert zero.shape == (1, 10) and zero.sum() == 0


@pytest.mark.parametrize("direction", [[1, 2, 0], [0, 0, 0], [2, 1, 1]])
def test_tailored_pattern_matches_jax_and_expand(direction):
    ranges = [range(0, 4), range(4, 10), range(10, K)]
    blocks = [[experimental.combination_block(K, r.start, r.stop, lvl)
               for lvl in range(3)] for r in ranges]
    got = experimental.tailored_pattern(direction, blocks)
    np.testing.assert_array_equal(got, jexp.tailored_pattern(direction, blocks))
    expanded = expand_pattern(direction, ranges, K)
    assert got.shape == expanded.shape and got.dtype == np.int8
    assert set(map(tuple, got.tolist())) == set(map(tuple, expanded.tolist()))


@pytest.mark.parametrize("seed", [None, 9])
def test_candidate_matrix_matches_jax(preps, seed):
    jprep, prep = preps
    teps = _teps(seed)
    got = experimental.candidate_matrix(prep, torch.as_tensor(teps), K)
    want = np.asarray(jexp.candidate_matrix(jprep, jnp.asarray(teps), K))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_candidate_matrix_valid_codewords(preps):
    _, prep = preps
    cand = experimental.candidate_matrix(prep, torch.as_tensor(_teps(9)), K).numpy()
    m_mat = prep.m_matrix.numpy().astype(np.int64)
    for b in range(cand.shape[0]):
        synd = (cand[b, :, :CODE.n - K] + cand[b, :, CODE.n - K:] @ m_mat[b].T) % 2
        assert not synd.any()


def test_best_estimation_counts_noiseless():
    rng = np.random.default_rng(2)
    words = (rng.integers(0, 2, (8, K)) @ CODE.g % 2).astype(np.int32)
    llr = (1 - 2 * words).astype(np.float32)
    _, prep = _preps(llr, llr, words)
    teps = np.concatenate([np.zeros((1, K), np.int8),
                           experimental.combination_block(K, 0, K, 1)])
    assert experimental.best_estimation_counts(prep, torch.as_tensor(teps), K) == (8, 0)


@pytest.mark.parametrize("data", ["noisy", "refparity"])
def test_best_estimation_counts_matches_jax(data):
    if data == "noisy":
        rx, words = _frames(64, seed=7, sigma=0.9)
        updated = (rx * np.random.default_rng(8).uniform(0.7, 1.3, rx.shape)).astype(
            np.float32)
        jprep, prep = _preps(updated, rx, words)
        teps = _teps(11)
    else:
        blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
        jprep, prep = _preps(blob["llr"], blob["llr"], blob["labels"])
        with open(os.path.join(_ROOT, "runs", "r4_pipeline",
                               "decoding_path.json")) as fh:
            path = json.load(fh)["path"]
        teps = np.concatenate(jseg.build_tep_blocks(path, K, 6)[0])
    got = experimental.best_estimation_counts(prep, torch.as_tensor(teps), K)
    want = jexp.best_estimation_counts(jprep, jnp.asarray(teps), K)
    assert got == want
    assert 0 < got[0] < sum(got)
