"""Port OSD stack (gf2ops, segments, osd_disc, engine) vs the JAX package.

GE, the MRB and ``prepare`` are 0/1 and permutation arithmetic plus exact
gathers, so they must be bit-exact against both JAX GE routes (dense and
bit-packed).  ``lterm`` sums in another order: 1e-5 relative, the bound of
``tests/test_osd_disc_pallas.py``."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import gf2ops as jgf2
from short_ldpc_decoding_osd_tpu.ops import osd_disc_pallas as jodp
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import gf2ops, osd_disc
from short_ldpc_decoding_osd_tpu_torch.osd import engine, segments

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(code, b, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (b, code.k))
    words = (msgs @ code.g % 2).astype(np.int32)
    noise = rng.normal(1.0, 0.9, (b, code.n))
    original = np.where(words == 0, noise, -noise).astype(np.float32)
    refined = (original * rng.uniform(0.8, 1.2, (b, code.n))).astype(np.float32)
    # exact ties in |refined|: the stable co-sort must keep their order
    refined[:, 5] = refined[:, 9]
    return refined, original, words


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "array_121_60"])
def test_batched_row_reduce_bit_exact(code_name):
    code = jax_get_code(code_name)
    h = code.h_osd if code_name == "ccsds_128_64" else code.h  # rank-deficient
    rng = np.random.default_rng(0)
    perm = np.stack([rng.permutation(code.n) for _ in range(12)])
    h_p = h[:, perm].transpose(1, 0, 2)
    ref_mat, ref_order = jgf2.batched_row_reduce(jnp.asarray(h_p))
    mat, order = gf2ops.batched_row_reduce(torch.as_tensor(h_p))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(ref_mat))
    np.testing.assert_array_equal(order.numpy(), np.asarray(ref_order))


@pytest.mark.parametrize("use_packed", [False, True])
def test_identify_mrb_from_perm_bit_exact(use_packed):
    code = jax_get_code("ccsds_128_64")
    refined, _, _ = _frames(code, 16, seed=1)
    perm = np.argsort(np.abs(refined), axis=1, kind="stable")
    ref = jgf2.identify_mrb_from_perm(jnp.asarray(perm, jnp.int32),
                                      jnp.asarray(code.h_osd), code.k,
                                      use_packed=use_packed)
    got = gf2ops.identify_mrb_from_perm(torch.as_tensor(perm), code.h_osd, code.k)
    for key in ("m_matrix", "index_order", "swap_len", "lrb_ranks"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


def test_prepare_bit_exact():
    code = jax_get_code("ccsds_128_64")
    refined, original, words = _frames(code, 24, seed=2)
    ref = jengine.prepare(jnp.asarray(refined), jnp.asarray(original),
                          jnp.asarray(words), jnp.asarray(code.h_osd), code.k)
    got = engine.prepare(torch.as_tensor(refined), torch.as_tensor(original),
                         torch.as_tensor(words), code.h_osd, code.k)
    for field in ("order_updated", "order_original", "order_labels",
                  "m_matrix", "swap_len", "lrb_ranks", "hard_original",
                  "hard_updated", "mag_original"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    # a 128-term f32 sum: XLA and torch may associate it differently
    np.testing.assert_allclose(got.truth_discrepancy.numpy(),
                               np.asarray(ref.truth_discrepancy), rtol=1e-6)


def test_tep_chunks_equal_for_r4_path():
    with open(os.path.join(_ROOT, "runs", "r4_pipeline", "decoding_path.json")) as fh:
        path = json.load(fh)["path"]
    blocks, acc = segments.build_tep_blocks(path, 64, 6)
    ref_blocks, ref_acc = jseg.build_tep_blocks(path, 64, 6)
    np.testing.assert_array_equal(acc, ref_acc)
    for a, b in zip(blocks, ref_blocks):
        np.testing.assert_array_equal(a, b)
    teps, mask, bounds = segments.pack_tep_chunks(blocks)
    ref_teps, ref_mask, ref_bounds = jseg.pack_tep_chunks(ref_blocks)
    assert teps.shape == (6, 256, 64) and int(mask.sum()) == 1439
    np.testing.assert_array_equal(teps, ref_teps)
    np.testing.assert_array_equal(mask, ref_mask)
    assert bounds == ref_bounds
    np.testing.assert_array_equal(segments.segment_sizes(64),
                                  jseg.segment_sizes(64))
    assert segments.conventional_path(3) == jseg.conventional_path(3)


@pytest.mark.parametrize("b,m,k,ntot,seed", [
    (16, 64, 64, 700, 0),    # CCSDS shapes, unaligned Ntot
    (5, 61, 60, 130, 1),     # rank-deficient 121_60-like, odd B
    (8, 128, 128, 512, 2),   # 256_128 shapes
    (4, 48, 48, 130, 3),     # qc_96_48
    (3, 192, 192, 513, 4),   # wimaxlike_384_192
    (2, 176, 880, 600, 5),   # wimax_1056_880: k > 256
])
def test_lterm_reference_matches_jax_kernel(b, m, k, ntot, seed):
    rng = np.random.default_rng(seed)
    m_mat = rng.integers(0, 2, (b, m, k)).astype(np.int8)
    u_l = rng.normal(0, 1.5, (b, m)).astype(np.float32)
    teps = rng.integers(0, 2, (ntot, k)).astype(np.int8)
    want = np.asarray(jodp.lterm_pallas(jnp.asarray(m_mat), jnp.asarray(u_l),
                                        jnp.asarray(teps), interpret=True))
    got = osd_disc.lterm(torch.as_tensor(m_mat), torch.as_tensor(u_l),
                         torch.as_tensor(teps)).numpy()
    scale = np.maximum(np.abs(want), 1.0)
    assert (np.abs(got - want) / scale).max() < 1e-5


@pytest.mark.parametrize("shape", [
    ("array_121_60",), ("array_121_80",), ("ccsds_128_64",), ("code1_64_32",),
    ("qc_96_48",), ("wimax_1056_880",), ("wimaxlike_384_192",),
    (32768, 64, 64, 1536),  # the main path: 32,768 captured rows, 1,536 TEPs
    (5, 61, 60, 130), (256, 176, 880, 1536), (1, 1, 1, 1),
    (1024, 176, 880, 102912),  # the WiMAX system: a round's rows, the full path
    (4096, 192, 192, 1536),  # wimaxlike_384_192
    (5, 61, 100, 130)],  # ragged: k not a multiple of 16, a small B and N
    ids=lambda s: s[0] if len(s) == 1 else "x".join(map(str, s)))
def test_lterm_plan_covers_every_code(shape):
    """K5's tile plan takes every packaged code's (m, k) = (n - k, k) at the
    main path's batch and TEP count, WiMAX included: it fits a block's
    shared memory, its tiles cover (B, m, k, N), and its launch is one the
    kernel has (resident (2, 8), or the general plan: a frame of m rounded
    up to 16 rows and k to its k-slice beside two rings of TEP stages, the
    grid filling the SMs)."""
    if len(shape) == 1:
        code = get_code(shape[0])
        shape = (32768, code.n - code.k, code.k, 1536)
    b, m, k, ntot = shape
    plan = osd_disc.lterm_plan(b, m, k, ntot)
    assert plan is not None
    assert plan.smem_bytes <= 232_448
    if plan.resident:
        assert plan.smem_bytes == (plan.stride * plan.nt + plan.nbuf * (
            plan.stride * plan.m_pad + 8 * plan.m_pad))
        assert plan.stride == plan.k_pad + 16 and (plan.stride // 16) % 2 == 1
        assert m <= plan.m_pad and plan.m_pad % (8 * plan.tn) == 0
        assert plan.m_pad <= osd_disc.THREADS
        # the one resident launch: a 64 x 64 frame
        assert m <= 64 and k <= 64
        assert (plan.kch, plan.tn, plan.m_pad, plan.k_pad) == (2, 8, 64, 64)
        # TEP tiles: multiples of 16 that cover N, none empty
        assert plan.nt % 16 == 0 and plan.nt * plan.n_tiles >= ntot
        assert plan.nt * (plan.n_tiles - 1) < ntot
        assert plan.nbuf in (1, 2)
        assert plan.grid[1] == plan.n_tiles and 1 <= plan.grid[0] <= b
        assert plan.grid[0] * plan.grid[1] <= osd_disc.H100_SMS or plan.grid[0] == 1
        if shape == (32768, 64, 64, 1536):
            # every TEP resident in one tile, two frame buffers, a block an SM
            assert (plan.kch, plan.nt, plan.n_tiles, plan.nbuf, plan.grid) == (
                2, 1536, 1, 2, (132, 1))
        return
    assert m > 64 or k > 64
    assert (plan.kch, plan.tn, plan.nbuf, plan.grid[1]) == (0, 0, 1, 1)
    # k_pad: the least multiple of the k-slice at or above k, the slice the
    # widest of those that pad k least; m_pad: the least multiple of 16
    assert plan.stride in (32, 64, 128)
    assert plan.k_pad % plan.stride == 0 and k <= plan.k_pad < k + plan.stride
    assert plan.k_pad == min(-(-k // s) * s for s in (32, 64, 128))
    assert plan.m_pad % 16 == 0 and m <= plan.m_pad < m + 16
    # the frame beside two rings of 64-TEP stages (and their barriers)
    assert osd_disc.MIN_STAGES <= plan.stages <= osd_disc.MAX_STAGES
    assert plan.smem_bytes == (1024 + 2 * plan.stages * (64 * plan.stride + 16)
                               + plan.m_pad * plan.k_pad + 8 * plan.m_pad)
    if plan.stages < osd_disc.MAX_STAGES:  # as many stages as fit
        assert plan.smem_bytes + 2 * (64 * plan.stride + 16) > 232_448
    # TEP tiles of 64 in units of nt that cover N, none empty
    tiles = -(-ntot // 64)
    assert plan.nt % 64 == 0 and plan.nt * plan.n_tiles >= ntot
    assert plan.nt * (plan.n_tiles - 1) < ntot
    # the grid fills the SMs wherever b times the TEP tiles allows
    assert plan.grid[0] == min(osd_disc.H100_SMS, b * tiles)
    assert plan.grid[0] <= b * plan.n_tiles
    if shape == (1024, 176, 880, 102912):
        assert (plan.m_pad, plan.k_pad, plan.stride, plan.stages) == (
            176, 896, 128, 4)
    if shape == (4096, 192, 192, 1536):
        assert (plan.m_pad, plan.k_pad, plan.stride, plan.stages) == (
            192, 192, 64, 8)


@pytest.mark.parametrize("shape", [
    (1024, 176, 880, 102912), (400, 192, 192, 58368), (5, 61, 100, 130),
    (3, 250, 96, 200), (200, 128, 128, 8192)],
    ids=lambda s: "x".join(map(str, s)))
def test_lterm_general_units_cover_every_tile_once(shape):
    """The general kernel's loops, written out: persistent blocks take units
    blockIdx.x, + grid, ...; a unit is frame u // n_tiles against its chunk
    of nt / 64 TEP tiles, which the two warpgroups split by parity (each
    fed by its own producer ring, stage by stage).  Every (frame, TEP
    tile) is computed exactly once and the blocks' loads differ by at most
    one unit."""
    b, m, k, ntot = shape
    plan = osd_disc.lterm_plan(b, m, k, ntot)
    tiles, tpc = -(-ntot // 64), plan.nt // 64
    units = b * plan.n_tiles
    seen = np.zeros((b, tiles), np.int64)
    per_block = []
    for blk in range(plan.grid[0]):
        done = 0
        for u in range(blk, units, plan.grid[0]):
            f, c = divmod(u, plan.n_tiles)
            for wg in (0, 1):
                for tile in range(c * tpc + wg, min((c + 1) * tpc, tiles), 2):
                    seen[f, tile] += 1
            done += 1
        per_block.append(done)
    assert (seen == 1).all()
    assert max(per_block) - min(per_block) <= 1


def test_lterm_plan_refuses_only_what_does_not_fit():
    assert osd_disc.lterm_plan(8, 64, 4096, 16) is None  # a frame > 227 KB
    assert osd_disc.lterm_plan(8, 600, 64, 16) is None  # m beyond a block
    with pytest.raises(ValueError, match="positive"):
        osd_disc.lterm_plan(0, 64, 64, 16)


def _fcn(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.8, (6, 6)).astype(np.float32),
            rng.normal(0, 0.8, (6, 2)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sliding_walk_equals_scan_and_jax(seed):
    rng = np.random.default_rng(seed)
    minima = rng.gamma(2.0, 1.5, (64, 30)).astype(np.float32)
    minima[:, 3] = minima[:, 2]  # ties in the window sort and the skip rule
    w1, w2 = _fcn(seed)
    fcn_t = {"w1": torch.as_tensor(w1), "w2": torch.as_tensor(w2)}
    fast = engine.sliding_walk(torch.as_tensor(minima), fcn_t, soft_margin=0.6)
    scan = engine._sliding_walk_scan(torch.as_tensor(minima), fcn_t,
                                     soft_margin=0.6)
    ref = jengine.sliding_walk(jnp.asarray(minima),
                               {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
                               soft_margin=0.6)
    for key in ("stop_k", "deep_limit", "global_min", "windows_evaluated",
                "window_num"):
        np.testing.assert_array_equal(fast[key].numpy(), scan[key].numpy(), key)
        np.testing.assert_array_equal(fast[key].numpy(), np.asarray(ref[key]), key)


def test_block_minima_padded_equals_chunked():
    code = jax_get_code("ccsds_128_64")
    refined, original, words = _frames(code, 12, seed=3)
    prep = engine.prepare(torch.as_tensor(refined), torch.as_tensor(original),
                          torch.as_tensor(words), code.h_osd, code.k)
    path = [[0] * 6, [1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0],
            [2, 0, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0]]
    blocks, _ = segments.build_tep_blocks(path, code.k, 6)
    teps, mask, bounds = segments.pack_tep_chunks(blocks, chunk=64)
    padded, pmask = segments.stack_padded_blocks(blocks)
    minima, argmins = engine.block_discrepancy_minima(
        prep, torch.as_tensor(teps), torch.as_tensor(mask), code.k, bounds)
    ref_min, ref_arg = engine.block_discrepancy_minima(
        prep, torch.as_tensor(padded), torch.as_tensor(pmask), code.k)
    np.testing.assert_allclose(minima.numpy(), ref_min.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(argmins.numpy(), ref_arg.numpy())
