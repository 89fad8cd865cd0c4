"""Port ``ops/gf2_bitpack.py`` (the packed GE route and the plain twin of
the CUDA GE kernel) against the JAX package's ``gf2_bitpack``, bit for bit.

Inputs are made with numpy from a seed and handed to both.  The packed
route is held to JAX's packed route step for step, rank-deficient raw H
included, where JAX's dense route differs from it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.codes import gf2 as jgf2rank
from short_ldpc_decoding_osd_tpu.ops import gf2_bitpack as jbp
from short_ldpc_decoding_osd_tpu.ops import gf2ops as jgf2
from short_ldpc_decoding_osd_tpu_torch import _kernels
from short_ldpc_decoding_osd_tpu_torch.codes import get_code, tables
from short_ldpc_decoding_osd_tpu_torch.ops import gf2_bitpack, gf2ops

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _permuted(h, b, seed):
    rng = np.random.default_rng(seed)
    return np.stack([h[:, rng.permutation(h.shape[1])] for _ in range(b)])


def _ccsds(b, seed):
    return _permuted(jax_get_code("ccsds_128_64").h, b, seed)


def _forced_swaps(b, seed):
    """Duplicated early columns: the diagonal walk must swap columns."""
    rng = np.random.default_rng(seed)
    h0 = jax_get_code("ccsds_128_64").h
    frames = []
    for _ in range(b):
        h = h0[:, rng.permutation(h0.shape[1])].copy()
        j = int(rng.integers(1, 40))
        h[:, j] = h[:, j - 1]
        frames.append(h)
    return np.stack(frames)


def _word_edges(b, seed):
    """qc_96_48 (3 words) with columns 30->31 and 62->63 duplicated: swaps
    that cross word edges."""
    frames = _permuted(jax_get_code("qc_96_48").h, b, seed)
    frames[:, :, 31] = frames[:, :, 30]
    frames[:, :, 63] = frames[:, :, 62]
    return frames


def _partial_word(b, seed):
    """n = 45, full-rank 16 x 45 frames: a partial last word."""
    rng = np.random.default_rng(seed)
    frames = []
    while len(frames) < b:
        h = (rng.uniform(size=(16, 45)) < 0.4).astype(np.uint8)
        if jgf2rank.rank(h) == 16:
            frames.append(h)
    return np.stack(frames)


CASES = {
    "ccsds_48": lambda: _ccsds(48, 1),
    "forced_swaps": lambda: _forced_swaps(32, 2),
    "qc_word_edges": lambda: _word_edges(16, 3),
    "n45_partial_word": lambda: _partial_word(8, 4),
    "wimax_1056_880_osd": lambda: _permuted(
        jax_get_code("wimax_1056_880").h_osd, 4, 5),
    "array_121_60_raw": lambda: _permuted(jax_get_code("array_121_60").h, 8, 6),
    "array_121_80_raw": lambda: _permuted(jax_get_code("array_121_80").h, 8, 7),
}


@pytest.mark.parametrize("n", [24, 32, 121, 128])
def test_pack_unpack_roundtrip(n):
    x = np.random.default_rng(n).integers(0, 2, (5, 16, n)).astype(np.uint8)
    packed = gf2_bitpack.pack_columns(torch.as_tensor(x))
    assert packed.shape == (16, -(-n // 32), 5) and packed.dtype == torch.int32
    _eq(packed, jbp.pack_columns(jnp.asarray(x)))
    _eq(gf2_bitpack.unpack_columns(packed, n), x.astype(np.int8))
    _eq(gf2_bitpack.unpack_columns(packed, n),
        jbp.unpack_columns(jbp.pack_columns(jnp.asarray(x)), n))


@pytest.mark.parametrize("name", ["ccsds_128_64", "array_121_60",
                                  "wimax_1056_880"])
def test_pack_permuted_matches_jax(name):
    code = jax_get_code(name)
    rng = np.random.default_rng(7)
    perm = np.stack([rng.permutation(code.n) for _ in range(6)])
    invperm = np.argsort(perm, axis=1)
    got = gf2_bitpack.pack_permuted(torch.as_tensor(invperm), code.h)
    _eq(got, jbp.pack_permuted(jnp.asarray(invperm), jnp.asarray(code.h)))
    dense = np.stack([code.h[:, p] for p in perm]).astype(np.uint8)
    _eq(got, jbp.pack_columns(jnp.asarray(dense)))


@pytest.mark.parametrize("n,k", [(128, 64), (121, 60), (121, 33), (96, 48),
                                 (45, 29)])
def test_unpack_tail_and_pack_positions_match_jax(n, k):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 2, (4, 16, n)).astype(np.uint8)
    packed = jbp.pack_columns(jnp.asarray(x))
    got = gf2_bitpack.unpack_tail_columns(torch.as_tensor(np.array(packed)),
                                          n, k)
    _eq(got, jbp.unpack_tail_columns(packed, n, k))
    _eq(got, x[:, :, n - k:].astype(np.int8))
    bits = rng.integers(0, 2, (n, 6)).astype(np.int32)
    nw = -(-n // 32)
    _eq(gf2_bitpack.pack_positions(torch.as_tensor(bits), nw),
        jbp.pack_positions(jnp.asarray(bits), nw))


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_packed_matches_jax(case):
    """``_reduce_packed`` and ``batched_row_reduce_bitpack`` equal JAX's on
    the JAX suite's cases, the 33-word WiMAX h_osd and the rank-deficient
    raw H of the two array codes; on those two JAX's dense route differs."""
    batch = CASES[case]().astype(np.uint8)
    b, m, n = batch.shape
    order0 = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, b))
    packed = jbp.pack_columns(jnp.asarray(batch))
    want_mat, want_ord = jbp._reduce_packed(packed, jnp.asarray(order0),
                                            m_steps=m)
    got_mat, got_ord = gf2_bitpack._reduce_packed(
        torch.as_tensor(np.array(packed)), torch.as_tensor(order0.copy()), m)
    _eq(got_mat, want_mat, "mat")
    _eq(got_ord, want_ord, "col_order")
    got_red, got_co = gf2_bitpack.batched_row_reduce_bitpack(torch.as_tensor(batch))
    want_red, want_co = jbp.batched_row_reduce_bitpack(jnp.asarray(batch))
    _eq(got_red, want_red, "reduced")
    _eq(got_co, want_co, "order")
    assert got_co.dtype == torch.int32 and got_red.dtype == torch.int8
    dense_red, dense_co = jgf2.batched_row_reduce(jnp.asarray(batch))
    same_as_dense = (np.array_equal(np.asarray(dense_red), np.asarray(want_red))
                     and np.array_equal(np.asarray(dense_co), np.asarray(want_co)))
    # the two JAX routes part only on rank-deficient H
    assert same_as_dense == (not case.endswith("_raw")), case


@pytest.mark.parametrize("name,raw", [("ccsds_128_64", False),
                                      ("qc_96_48", False),
                                      ("array_121_60", True),
                                      ("array_121_80", True)])
def test_identify_mrb_packed_matches_jax(name, raw):
    """``identify_mrb_from_perm(use_packed=True)`` on the CPU (the plain
    twin of the kernel's perm load) equals JAX's packed route, and
    ``identify_mrb(use_packed=True)`` (the dense load) equals JAX's packed
    reduction through the same post-processing; the CPU counts no kernel
    launch."""
    _kernels.reset_launches()
    code = jax_get_code(name)
    h = code.h if raw else code.h_osd
    k = code.n - h.shape[0]
    llr = np.random.default_rng(9).normal(0, 1, (7, code.n)).astype(np.float32)
    perm = np.argsort(np.abs(llr), axis=1, kind="stable")
    want = jgf2.identify_mrb_from_perm(jnp.asarray(perm, jnp.int32),
                                       jnp.asarray(h), k, use_packed=True)
    got = gf2ops.identify_mrb_from_perm(torch.as_tensor(perm), h, k,
                                        use_packed=True)
    h_p = np.stack([h[:, p] for p in perm]).astype(np.uint8)
    red, co = jbp.batched_row_reduce_bitpack(jnp.asarray(h_p))
    want_dense = jgf2._mrb_post(red[:, :, code.n - k:], co, code.n, k)
    got_dense = gf2ops.identify_mrb(torch.as_tensor(h_p), k, use_packed=True)
    for key in ("m_matrix", "index_order", "swap_len", "lrb_ranks"):
        _eq(got[key], want[key], key)
        _eq(got_dense[key], want_dense[key], key)
    assert _kernels.LAUNCHES["ge_packed"] == 0


def test_default_route_is_dense_on_cpu():
    """``use_packed=None`` on a CPU tensor is the dense route: on a
    rank-deficient H it gives JAX's dense answer, not the packed one."""
    code = jax_get_code("array_121_60")
    k = code.n - code.h.shape[0]
    perm = np.stack([np.random.default_rng(s).permutation(code.n)
                     for s in range(8)])
    dense = jgf2.identify_mrb_from_perm(jnp.asarray(perm, jnp.int32),
                                        jnp.asarray(code.h), k, use_packed=False)
    got = gf2ops.identify_mrb_from_perm(torch.as_tensor(perm), code.h, k)
    for key in ("m_matrix", "index_order", "swap_len", "lrb_ranks"):
        _eq(got[key], dense[key], key)


@pytest.mark.parametrize("name", ["ccsds_128_64", "qc_96_48", "code1_64_32",
                                  "array_121_60", "array_121_80",
                                  "wimaxlike_384_192", "wimax_1056_880"])
def test_ge_plan_takes_every_packaged_code(name):
    """The kernel's plan takes every packaged code's h_osd and raw H: one
    warp a frame at m <= 64 and n <= 128 (ceil(n/32) columns a lane), else
    one block a frame of 32 ceil(m/32) threads whose columns fit 8 a
    thread, each column's rows in registers."""
    code = get_code(name)
    for h in (code.h_osd, code.h):
        m, n = h.shape
        plan = gf2_bitpack.ge_plan(32768, m, n)
        mw = -(-m // 32)
        assert plan is not None
        if m <= 64 and n <= 128:
            assert (plan.mode, plan.threads, plan.grid) == ("warp", 256, 4096)
            assert (plan.cols, plan.words) == (-(-n // 32), mw)
        else:
            assert (plan.mode, plan.threads, plan.grid) == ("block", 32 * mw,
                                                            32768)
            assert plan.cols == min(c for c in (2, 4, 6, 8)
                                    if c * 32 * mw >= n)
            assert plan.words == min(w for w in (2, 4, 6, 8) if w >= mw)
        assert plan.cols * (32 if plan.mode == "warp" else plan.threads) >= n


def test_ge_plan_refuses_what_does_not_fit():
    assert gf2_bitpack.ge_plan(4, 2048, 1024) is None  # 262 KB of rows
    with pytest.raises(ValueError, match="positive"):
        gf2_bitpack.ge_plan(0, 64, 128)


def test_packed_h_columns_and_refusals():
    """H packed by columns (the kernel's perm load) is held by
    ``codes.tables`` per matrix and device, a tensor's words equal the
    array's, and a tensor on neither the CPU nor CUDA is refused, not
    routed."""
    code = get_code("array_121_60")
    hcol = tables.get(code.h, gf2_bitpack._packed_h_columns, "cpu")
    assert hcol.shape == (121, 3) and hcol.dtype == torch.int32
    assert tables.get(code.h, gf2_bitpack._packed_h_columns, "cpu") is hcol
    assert torch.equal(tables.get(torch.as_tensor(code.h),
                                  gf2_bitpack._packed_h_columns, "cpu"), hcol)
    words = hcol.numpy().view(np.uint32).astype(np.int64)
    rows = np.arange(code.h.shape[0])
    bits = (words[:, rows // 32] >> (rows % 32)) & 1  # (n, m)
    np.testing.assert_array_equal(bits.T, code.h)
    meta = torch.empty((2, 128), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gf2_bitpack.reduce_from_perm(meta, code.h, 60)
