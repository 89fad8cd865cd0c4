"""The port's ``baselines/common.py`` vs the JAX package (CPU): the G-domain
preparation, the candidate distance terms and the TEP distances, on the
small code of ``tests/test_baselines.py`` and on the 256 CCSDS frames of
``runs/refparity/base_failures.npz``.

Tolerances: ``p_matrix``, labels and the permutation exact; ``inputs``
rtol 1e-6 (a gather: exact in practice); ``wd`` within 1e-6 of the
magnitude of its summands (f32 sums of signed terms in another order:
near cancellation they differ by more than 1e-6 of the sum itself);
``hd`` exact (integer-valued).  The two GE routes (the
dense route and the GE kernel's plain twin) agree bit for bit on every
G-domain input used, and every packaged code's G has full row rank.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.baselines import common as jcommon
from short_ldpc_decoding_osd_tpu.baselines import fs_osd as jfs
from short_ldpc_decoding_osd_tpu.baselines import pb_osd as jpb
from short_ldpc_decoding_osd_tpu_torch.baselines import common
from short_ldpc_decoding_osd_tpu_torch.codes import get_code, gf2
from short_ldpc_decoding_osd_tpu_torch.codes.code import _REGISTRY_BUILDERS
from short_ldpc_decoding_osd_tpu_torch.ops import gf2_bitpack, gf2ops

import golden_baselines as gb
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from torch_baselines_common import (ccsds_codes, noisy_batch, refparity,
                                    small_codes)


def _inputs(name):
    """(port code, JAX code, llr, words) of a named input set."""
    if name == "small":
        port, jax_code = small_codes()
        llr, words = noisy_batch(port, 24, 2.0, 0)
        return port, jax_code, llr, words
    port, jax_code = ccsds_codes()
    blob = refparity()
    return port, jax_code, blob["llr"], blob["labels"]


@pytest.fixture(scope="module", params=["small", "refparity"])
def prepared(request):
    port, jax_code, llr, words = _inputs(request.param)
    k = port.k
    jprep = jcommon.prepare_g_domain(jnp.asarray(llr), jnp.asarray(words),
                                     jnp.asarray(jax_code.g), k)
    prep = common.prepare_g_domain(torch.as_tensor(llr), torch.as_tensor(words),
                                   port.g, k)
    # the permutation: labels 0..n-1 (n <= 128 fits int8) come back permuted
    iota = np.broadcast_to(np.arange(port.n), llr.shape).copy()
    jperm = np.asarray(jcommon.prepare_g_domain(
        jnp.asarray(llr), jnp.asarray(iota), jnp.asarray(jax_code.g), k)["labels"])
    perm = common.prepare_g_domain(torch.as_tensor(llr), torch.as_tensor(iota),
                                   port.g, k)["labels"].numpy()
    return {"name": request.param, "code": port, "llr": llr, "words": words,
            "jprep": jprep, "prep": prep, "jperm": jperm, "perm": perm}


def test_prepare_g_domain_matches_jax(prepared):
    jprep, prep = prepared["jprep"], prepared["prep"]
    np.testing.assert_array_equal(prepared["perm"], prepared["jperm"])
    np.testing.assert_array_equal(prep["p_matrix"].numpy(),
                                  np.asarray(jprep["p_matrix"]))
    np.testing.assert_array_equal(prep["labels"].numpy(),
                                  np.asarray(jprep["labels"]))
    np.testing.assert_allclose(prep["inputs"].numpy(), np.asarray(jprep["inputs"]),
                               rtol=1e-6, atol=0)
    assert prep["p_matrix"].dtype == torch.int8
    assert prep["labels"].dtype == torch.int8


def test_prepare_g_domain_matches_host_golden(prepared):
    """Against ``golden_baselines.host_prepare_g`` (the reference's serial
    elimination), frame by frame, and the label re-encodes through P."""
    code, prep = prepared["code"], prepared["prep"]
    k = code.k
    for i in range(0, len(prepared["llr"]), 17):
        in_ref, lab_ref, p_ref = gb.host_prepare_g(
            prepared["llr"][i], prepared["words"][i], code.g, k)
        np.testing.assert_array_equal(prep["inputs"][i].numpy(), in_ref)
        np.testing.assert_array_equal(prep["labels"][i].numpy(), lab_ref)
        np.testing.assert_array_equal(prep["p_matrix"][i].numpy(), p_ref)
        assert np.array_equal((lab_ref[:k] @ p_ref) % 2, lab_ref[k:])


def test_ge_routes_agree_on_g_domain(prepared):
    """The dense route and the GE kernel's dense-load twin agree bit for
    bit on every G-domain input (full-row-rank G): the tail and col_order."""
    code, llr = prepared["code"], prepared["llr"]
    order = torch.sort(-torch.as_tensor(llr).abs(), dim=-1, stable=True).indices
    g_sorted = gf2ops.permute_columns(order, code.g)
    reduced, col_order = gf2ops.batched_row_reduce(g_sorted)
    tail, col_order_packed = gf2_bitpack.reduce_dense(g_sorted, code.n - code.k)
    assert col_order_packed.dtype == torch.int32
    assert torch.equal(tail, reduced[:, :, code.k:])
    assert torch.equal(col_order_packed.long(), col_order)
    assert torch.equal(reduced[:, :, :code.k],
                       torch.eye(code.k, dtype=torch.int8).expand(len(llr), -1, -1))


def test_candidate_distance_terms_match_jax(prepared):
    code = prepared["code"]
    jterms = jcommon.candidate_distance_terms(prepared["jprep"], code.k)
    terms = common.candidate_distance_terms(prepared["prep"], code.k)
    for key in ("hard", "mag", "mrb0", "lrb0", "d0", "uw_m", "uw_l", "c_h",
                "uh_m", "uh_l"):
        np.testing.assert_array_equal(terms[key].numpy(), np.asarray(jterms[key]),
                                      err_msg=key)
    np.testing.assert_allclose(terms["c_w"].numpy(), np.asarray(jterms["c_w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("tep_kind", ["fs", "pb"])
def test_tep_distances_match_jax(prepared, tep_kind):
    """wd to 1e-6 of its summands' magnitude, hd exact, against JAX's
    ``tep_distances``,
    on the baseline's own TEP set (order 2 on the small code, the first
    4,096 order-3 TEPs on CCSDS)."""
    code = prepared["code"]
    order = 2 if prepared["name"] == "small" else 3
    teps = (jfs.sequential_tep_matrix(code.k, order)[0] if tep_kind == "fs"
            else jpb.weight_limited_teps(code.k, order))[:4096]
    jterms = jcommon.candidate_distance_terms(prepared["jprep"], code.k)
    jwd, jhd, _ = jcommon.tep_distances(jterms, jnp.asarray(teps),
                                        prepared["jprep"]["p_matrix"])
    terms = common.candidate_distance_terms(prepared["prep"], code.k)
    wd, hd = common.tep_distances(terms, torch.as_tensor(teps),
                                  prepared["prep"]["p_matrix"])
    # relative to the magnitude of the summands (c_w, the MRB terms and the
    # parity terms, each taken absolute): an f32 sum of signed terms in
    # another order differs by ulps of the summands, not of the sum
    p_matrix = prepared["prep"]["p_matrix"]
    scale = (terms["c_w"].abs()[:, None]
             + common.mrb_term(terms["uw_m"].abs(), torch.as_tensor(teps))
             + common.parity_term(p_matrix, terms["uw_l"].abs(),
                                  torch.as_tensor(teps)))
    excess = (wd - torch.tensor(np.asarray(jwd))).abs() - 1e-6 * scale
    assert float(excess.max()) <= 0.0, float(excess.max())
    np.testing.assert_array_equal(hd.numpy(), np.asarray(jhd))
    wd_only, none = common.tep_distances(terms, torch.as_tensor(teps),
                                         prepared["prep"]["p_matrix"],
                                         with_hd=False)
    assert none is None and torch.equal(wd_only, wd)


def test_parity_term_is_k5_function(prepared):
    """``parity_term`` is K5's function with M = P^T: against an f64
    evaluation of ``sum_l u_l * mod2(e @ P)`` (to 1e-6 of its summands'
    magnitude), over a TEP count that leaves a partial CPU block."""
    code, prep = prepared["code"], prepared["prep"]
    teps = torch.as_tensor(jpb.weight_limited_teps(code.k, 3)
                           [:common.CPU_TEP_BLOCK + 37])
    terms = common.candidate_distance_terms(prep, code.k)
    got = common.parity_term(prep["p_matrix"], terms["uw_l"], teps)
    parity = torch.einsum("bkl,nk->bnl", prep["p_matrix"].double(),
                          teps.double()).remainder(2.0)
    want = torch.einsum("bl,bnl->bn", terms["uw_l"].double(), parity)
    scale = torch.einsum("bl,bnl->bn", terms["uw_l"].abs().double(), parity)
    assert got.shape == (len(prepared["llr"]), teps.shape[0])
    assert got.dtype == torch.float32
    assert float(((got.double() - want).abs() - 1e-6 * scale).max()) <= 0.0


def test_tep_distances_affine_map_host_golden():
    """Port of ``test_tep_distances_affine_map``: wd and hd against the
    serial re-encode of ``golden_baselines._dist``."""
    code, _ = small_codes()
    llr, words = noisy_batch(code, 4, 2.0, 1)
    prep = common.prepare_g_domain(torch.as_tensor(llr), torch.as_tensor(words),
                                   code.g, code.k)
    terms = common.candidate_distance_terms(prep, code.k)
    teps = jpb.weight_limited_teps(code.k, 2)[:40]
    wd, hd = common.tep_distances(terms, torch.as_tensor(teps), prep["p_matrix"])
    for i in range(4):
        in_ref, _, p_ref = gb.host_prepare_g(llr[i], words[i], code.g, code.k)
        hard = np.where(in_ref > 0, 0, 1)
        mag = np.abs(in_ref)
        for t in range(0, 40, 7):
            wd_ref, hd_ref, _ = gb._dist(teps[t].astype(int), hard[:code.k], None,
                                         p_ref, hard, mag)
            assert float(wd[i, t]) == pytest.approx(wd_ref, rel=1e-5), (i, t)
            assert float(hd[i, t]) == hd_ref, (i, t)


@pytest.mark.parametrize("name", sorted(_REGISTRY_BUILDERS))
def test_every_packaged_g_has_full_row_rank(name):
    """The G-domain GE runs the GE kernel on the card and the dense route
    on the CPU; the two agree on full-row-rank input, which every packaged
    code's G is."""
    code = get_code(name)
    assert gf2.rank(code.g) == code.k == code.g.shape[0]
    common.check_full_row_rank(code.g)  # does not raise


def test_prepare_g_domain_raises_on_rank_deficient_g():
    code, _ = small_codes()
    g = code.g.copy()
    g[-1] = g[0] ^ g[1]
    llr, words = noisy_batch(code, 2, 2.0, 3)
    with pytest.raises(ValueError, match="full row rank"):
        common.prepare_g_domain(torch.as_tensor(llr), torch.as_tensor(words), g,
                                code.k)
