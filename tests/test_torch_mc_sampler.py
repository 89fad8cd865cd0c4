"""The port's hash sampler and compaction schedule vs the JAX package (CPU).

The hash sampler (``ops/mc_hash.py``) is held bit for bit against a numpy
golden and against JAX's ``mc_cascade._mix``/``_stream_bits``/``_sample``
run through a tiny interpret-mode Pallas kernel; normals agree to 1e-5
(measured worst 1.32e-6 against the f64 golden and 2.4e-7 against JAX: the
f32 uniforms and 2 pi u2 round before the transcendentals, which the port
evaluates in f64 on the CPU).  ``build_rows_schedule`` equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.channel import sigma_for_snr
from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import mc_cascade as jcascade
from short_ldpc_decoding_osd_tpu.ops import nms_edge_pallas as jedge
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import mc_hash, nms_edge
from torch_mc_common import _MASK, _mix_np, _sample_np

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _jax_words(fids, seed, n_streams):
    """JAX's in-kernel hash words through a tiny interpret-mode kernel."""
    from jax.experimental import pallas as pl

    b = fids.shape[0]

    def kern(f_ref, o_ref):
        base = jcascade._mix(f_ref[:] * jcascade._GOLD1 + jnp.int32(seed))
        sk = jax.lax.broadcasted_iota(jnp.int32, (b, n_streams), 1) + 1
        o_ref[:] = jcascade._stream_bits(base, sk)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((b, n_streams), jnp.int32),
        interpret=True,
    )(jnp.asarray(fids, jnp.int32)[:, None])


def _jax_sample(fids, seed, code, sigma):
    """JAX's ``_sample`` (codeword, llr) through a tiny interpret kernel."""
    from jax.experimental import pallas as pl

    b, n, k = fids.shape[0], code.n, code.k

    def kern(f_ref, g_ref, cw_ref, llr_ref):
        cw, llr = jcascade._sample(f_ref[:], jnp.int32(seed), g_ref[:],
                                   jnp.float32(sigma), jnp.float32(1.0), n, k)
        cw_ref[:] = cw
        llr_ref[:] = llr

    shape = jax.ShapeDtypeStruct((b, n), jnp.float32)
    return pl.pallas_call(kern, out_shape=(shape, shape), interpret=True)(
        jnp.asarray(fids, jnp.int32)[:, None], jnp.asarray(code.g, jnp.float32))


# --- sampler ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 2**31 - 1])
def test_hash_words_match_golden_and_jax(seed):
    fids = np.array([0, 1, 2, 255, 1 << 20, (1 << 21) - 1, 2_097_151], np.int64)
    base = mc_hash.base_words(torch.as_tensor(fids), seed)[:, None]
    streams = torch.arange(1, 17, dtype=torch.int64)
    got = mc_hash.stream_bits(base, streams).numpy().astype(np.uint64)
    gold1 = np.uint64(np.uint32(jcascade._GOLD1))
    gold2 = np.uint64(np.uint32(jcascade._GOLD2))
    gbase = _mix_np((fids.astype(np.uint64) * gold1 + np.uint64(seed)) & _MASK)
    want = _mix_np(gbase[:, None] ^ ((np.arange(1, 17, dtype=np.uint64)[None] * gold2)
                                     & _MASK))
    np.testing.assert_array_equal(got, want)
    jax_words = np.asarray(_jax_words(fids, seed, 16)).astype(np.uint32)
    np.testing.assert_array_equal(got.astype(np.uint32), jax_words)


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48"])
def test_sample_matches_golden_and_jax(code_name):
    code = jax_get_code(code_name)
    sigma = float(sigma_for_snr(3.0, code.rate))
    fids = np.arange(0, 4096, 17, dtype=np.int64)
    seed = 11
    cw_g, llr_g, words_g = _sample_np(fids, seed, code, sigma)
    base = mc_hash.base_words(torch.as_tensor(fids), seed)[:, None]
    bits = (mc_hash.stream_bits(base, torch.arange(1, code.k + 1)) & 1).numpy()
    np.testing.assert_array_equal(bits, (words_g & np.uint64(1)).astype(np.int64))
    cw, llr = mc_hash.sample(torch.as_tensor(fids), seed,
                             torch.as_tensor(code.g, dtype=torch.float32), sigma)
    np.testing.assert_array_equal(cw.numpy(), cw_g)
    np.testing.assert_allclose(llr.numpy(), llr_g, rtol=1e-5, atol=1e-5)
    jcw, jllr = _jax_sample(fids, seed, code, sigma)
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
    np.testing.assert_allclose(llr.numpy(), np.asarray(jllr), rtol=1e-5, atol=1e-5)


def _mixed_g():
    """qc_96_48's G with its rows mixed by a seeded invertible GF(2) matrix
    (unit lower-triangular, so some columns keep weight 1) and column 5
    zeroed: G no longer systematic, columns of weight 0, 1 and more."""
    g = get_code("qc_96_48").g.astype(np.int64)
    k = g.shape[0]
    rng = np.random.default_rng(25)
    mix = np.tril(rng.random((k, k)) < 0.08, -1).astype(np.int64) + np.eye(
        k, dtype=np.int64)
    mixed = (mix @ g) % 2
    mixed[:, 5] = 0
    return mixed.astype(np.uint8)


# G of each case and its counts of unit columns and of the others
_G_CASES = {
    "ccsds_128_64": (lambda: get_code("ccsds_128_64").g, (64, 64)),
    "wimax_1056_880": (lambda: get_code("wimax_1056_880").g, (880, 176)),
    "qc_96_48": (lambda: get_code("qc_96_48").g, (48, 48)),
    "wimaxlike_384_192": (lambda: get_code("wimaxlike_384_192").g, (192, 192)),
    "mixed_qc_96_48": (_mixed_g, None),
}


@pytest.mark.parametrize("code_name", list(_G_CASES))
def test_gen_columns_encode(code_name):
    """The kernels' encode operand (``nms_edge.encode_tables``): a unit
    column's bit read from the message words and a popcount over the
    word-major parity table equal msg @ G mod 2 exactly, also for k > 32
    words (WiMAX k = 880) and for a G that is not systematic."""
    build, counts = _G_CASES[code_name]
    g = np.asarray(build(), dtype=np.uint8)
    k, n = g.shape
    kw = (k + 31) // 32
    columns, parity = nms_edge.encode_tables(g)
    parity = parity.view(np.uint32)
    weight = g.sum(axis=0)
    units = int((columns >= 0).sum())
    assert units == int((weight == 1).sum())
    if counts is not None:
        assert (units, n - units) == counts
    else:
        assert 0 < units < n and (weight == 0).any() and (weight >= 2).any()

    # layout: a unit column holds the row of its one bit; the others are
    # numbered in column order, and word w of parity column p lies at
    # (w, p), its bit b being G[32 w + b] of that column
    unit = columns >= 0
    np.testing.assert_array_equal(columns[unit], g[:, unit].argmax(axis=0))
    others = np.flatnonzero(~unit)
    np.testing.assert_array_equal(~columns[others], np.arange(len(others)))
    assert parity.shape == (kw, len(others)) and parity.flags.c_contiguous
    bits = (parity[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    np.testing.assert_array_equal(bits.reshape(kw * 32, -1)[:k], g[:, others])
    assert not bits.reshape(kw * 32, -1)[k:].any()
    # the kernels' operand: the column kinds, then the parity words flat,
    # so word w of parity column p sits at n + w P + p
    flat = nms_edge.encode_tensor(g, "cpu").numpy()
    np.testing.assert_array_equal(flat[:n], columns)
    np.testing.assert_array_equal(flat[n:].view(np.uint32), parity.ravel())
    assert nms_edge.parity_columns(torch.as_tensor(flat), n, k) == len(others)

    # the encode as a lane runs it, on the message words
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, (16, k))
    padded = np.zeros((16, kw * 32), np.uint64)
    padded[:, :k] = msg
    words = (padded.reshape(16, kw, 32)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    code = np.empty((16, n), np.int64)
    for v in range(n):
        j = int(columns[v])
        if j >= 0:
            code[:, v] = (words[:, j >> 5] >> np.uint32(j & 31)) & 1
        else:
            anded = words & parity[:, ~j][None]
            code[:, v] = np.unpackbits(anded.view(np.uint8), axis=-1).sum(-1) % 2
    np.testing.assert_array_equal(code, msg @ g.astype(np.int64) % 2)


# --- build_rows_schedule ----------------------------------------------------

def test_build_rows_schedule_matches_jax():
    assert nms_edge.DEFAULT_COMPACT_SCHEDULE == jedge.DEFAULT_COMPACT_SCHEDULE
    cases = [(((4, 0.5), (2, 0.25)), 512, 12), (((4, 0.5), (2, 0.25)), 512, 6),
             (((4, 0.5),), 512, 4), (((4, 0.05),), 512, 12),
             (jedge.DEFAULT_COMPACT_SCHEDULE, 512, 12),
             (((2, 0.9), (2, 0.95), (2, 0.5)), 512, 12)]
    cases += [(((4, frac),), block, iters) for block in (64, 128, 256, 512)
              for frac in (0.05, 0.3, 0.40625, 0.5, 0.77, 1.0, 2.0)
              for iters in (2, 5, 12)]
    for case in cases:
        assert nms_edge.build_rows_schedule(*case) == jedge.build_rows_schedule(*case)
    assert nms_edge.build_rows_schedule(((4, 0.5), (2, 0.25)), 512, 12) == (
        ((4, 256), (2, 128)), 6)

