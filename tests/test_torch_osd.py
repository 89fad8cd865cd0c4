"""Port OSD stack (gf2ops, segments, osd_disc, engine) vs the JAX package.

GE, the MRB and ``prepare`` are 0/1 and permutation arithmetic plus exact
gathers, so they must be bit-exact against both JAX GE routes (dense and
bit-packed).  ``lterm`` sums in another order: 1e-5 relative, the bound of
``tests/test_osd_disc_pallas.py``."""

import dataclasses
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
    layout = segments.TepLayout.from_blocks(blocks, "cpu", chunk=64)
    minima, argmins = engine.block_discrepancy_minima(prep, layout, code.k)
    ref_min, ref_arg = _jax_padded_minima(prep, blocks, code.k)
    np.testing.assert_allclose(minima.numpy(), ref_min, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(argmins.numpy(), ref_arg)


def _jax_padded_minima(prep, blocks, k):
    """JAX's padded scan (its ``engine.block_discrepancy_minima`` without
    ``bounds``) on the port's prepared batch and TEP blocks: (minima,
    argmins) as numpy."""
    jprep = jengine.PreparedBatch(**{
        f.name: None if getattr(prep, f.name) is None
        else jnp.asarray(getattr(prep, f.name).numpy())
        for f in dataclasses.fields(prep)})
    padded, pmask = jseg.stack_padded_blocks(blocks)
    minima, argmins = jengine.block_discrepancy_minima(
        jprep, jnp.asarray(padded), jnp.asarray(pmask), k)
    return np.asarray(minima), np.asarray(argmins)


def _dyadic_prep(b, m, k, seed):
    """A prepared batch whose weights are multiples of 1/8 below 8, so that
    every discrepancy is exact in f32 whatever the order of its sums: ties
    are exact on every route."""
    rng = np.random.default_rng(seed)
    n = m + k

    def bits():
        return torch.as_tensor(rng.integers(0, 2, (b, n)).astype(np.int8))

    return engine.PreparedBatch(
        order_updated=None, order_original=None, order_labels=None,
        m_matrix=torch.as_tensor(rng.integers(0, 2, (b, m, k)).astype(np.int8)),
        swap_len=None, lrb_ranks=None, hard_original=bits(),
        hard_updated=bits(),
        mag_original=torch.as_tensor(rng.integers(0, 64, (b, n)) / 8.0,
                                     dtype=torch.float32),
        truth_discrepancy=None)


def _random_blocks(rng, sizes, k, weight=None, duplicates=False):
    """TEP blocks of ``sizes`` rows: rows of ``weight`` ones, or dense random
    rows (``weight`` None); with ``duplicates`` some rows repeat others in
    the same block and in earlier blocks (exact ties)."""
    blocks = []
    for s in sizes:
        if weight is None:
            blk = rng.integers(0, 2, (s, k)).astype(np.int8)
        else:
            blk = np.zeros((s, k), np.int8)
            for r in range(s):
                blk[r, rng.choice(k, weight, replace=False)] = 1
        if duplicates and s > 2:
            blk[s - 1] = blk[0]
            blk[s // 2] = blk[0]
            if blocks and len(blocks[-1]):
                blk[1] = blocks[-1][0]
        blocks.append(blk)
    if duplicates:  # a block of one row repeated: its minimum ties everywhere
        blocks.append(np.repeat(blocks[-1][:1], 6, axis=0))
    return blocks


def _minima_case(name):
    """(prep, blocks, k, chunk, exact): the prepared batch, the TEP blocks,
    the chunk of the chunked layout, and whether the padded scan must
    agree bit for bit (dyadic weights) or to f32 rounding."""
    rng = np.random.default_rng(hash(name) % 2**32)
    if name == "r4_path":
        code = jax_get_code("ccsds_128_64")
        refined, original, words = _frames(code, 6, seed=8)
        prep = engine.prepare(torch.as_tensor(refined), torch.as_tensor(original),
                              torch.as_tensor(words), code.h_osd, code.k)
        with open(os.path.join(_ROOT, "runs", "r4_pipeline",
                               "decoding_path.json")) as fh:
            path = json.load(fh)["path"]
        blocks, _ = segments.build_tep_blocks(path, code.k, 6)
        assert (len(blocks), sum(len(b) for b in blocks)) == (30, 1439)
        return prep, blocks, code.k, 256, False
    if name == "straddle":  # blocks cut across 16- and 64-TEP tiles
        sizes, weight, m, k = [1, 15, 17, 0, 63, 65, 129, 3, 31], 2, 64, 64
    elif name == "empty":  # empty blocks first, inside and last
        sizes, weight, m, k = [0, 5, 0, 0, 20, 40, 0], 1, 64, 64
    elif name == "ties":
        sizes, weight, m, k = [7, 24, 3, 50, 9], 3, 48, 48
    else:  # "dense": a dense random T, on a general-plan shape
        sizes, weight, m, k = [40, 0, 90, 11], None, 61, 100
    blocks = _random_blocks(rng, sizes, k, weight, duplicates=name == "ties")
    return _dyadic_prep(5, m, k, 9), blocks, k, 64, True


def _unfused_minima(prep, layout, k):
    """The discrepancy minima as the port computed them before K5 took the
    epilogue: the (B, N) map ``c0 + lterm + u_m @ T^T`` with K5's ``lterm``,
    then each block's ``amin`` and ``first_argmin`` (the package's plain
    twin, given that parity term)."""
    c0, u_l, u_m, _ = engine._discrepancy_terms(prep, k)
    t_flat = layout.flat
    return osd_disc.block_minima_reference(
        prep.m_matrix, u_l, c0, u_m, t_flat, layout.block_of, layout.starts,
        layout.ntot, osd_disc.lterm(prep.m_matrix, u_l, t_flat))


@pytest.mark.parametrize("name", ["r4_path", "straddle", "empty", "ties", "dense"])
def test_block_minima_twin_equals_unfused_and_padded(name):
    """The chunked route (``osd_disc.block_minima``'s plain twin on the
    CPU) gives the unfused path's minima and first argmins bit for bit, and
    JAX's padded scan's (to f32 rounding, or exactly where every
    discrepancy is exact)."""
    prep, blocks, k, chunk, exact = _minima_case(name)
    layout = segments.TepLayout.from_blocks(blocks, "cpu", chunk=chunk)
    bounds, teps = layout.bounds, layout.teps
    got_min, got_arg = engine.block_discrepancy_minima(prep, layout, k)
    want_min, want_arg = _unfused_minima(prep, layout, k)
    assert got_min.dtype == torch.float32 and got_arg.dtype == torch.int64
    assert torch.equal(got_min, want_min) and torch.equal(got_arg, want_arg)
    pad_min, pad_arg = _jax_padded_minima(prep, blocks, k)
    if exact:
        np.testing.assert_array_equal(got_min.numpy(), pad_min)
    else:
        np.testing.assert_allclose(got_min.numpy(), pad_min, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(got_arg.numpy(), pad_arg)
    empty = [i for i, (s, e) in enumerate(bounds) if s == e]
    assert (got_min[:, empty] == engine._BIG).all()
    assert (got_arg[:, empty] == 0).all()
    if name == "ties":  # the repeated block ties everywhere: the first wins
        s, e = bounds[-1]
        flat = engine._tep_discrepancies(prep, teps.reshape(-1, k)[s:e].to(torch.int8),
                                         k)
        assert (flat == flat[:, :1]).all() and (got_arg[:, -1] == 0).all()


def test_chunked_minima_build_no_discrepancy_map(monkeypatch):
    """The chunked route reaches K5's block-minima entry alone: neither
    ``lterm`` nor the unfused discrepancy map runs."""

    def forbidden(*args, **kwargs):
        raise AssertionError("the chunked route built the (B, N) map")

    prep, blocks, k, chunk, _ = _minima_case("straddle")
    layout = segments.TepLayout.from_blocks(blocks, "cpu", chunk=chunk)
    want = _unfused_minima(prep, layout, k)
    seen = []
    real = osd_disc.block_minima
    monkeypatch.setattr(osd_disc, "lterm", forbidden)
    monkeypatch.setattr(engine, "_tep_discrepancies", forbidden)
    monkeypatch.setattr(osd_disc, "block_minima",
                        lambda *a: seen.append(a) or real(*a))
    got = engine.block_discrepancy_minima(prep, layout, k)
    assert len(seen) == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tep_positions_list_each_rows_set_columns():
    rng = np.random.default_rng(4)
    t = rng.integers(0, 2, (40, 70)).astype(np.int8)
    t[3] = 0  # a row with no set column
    t[7] = 1  # one with every column set
    t[5, :] = 0
    t[5, [69, 0, 33]] = 1
    t[6, :] = 0
    t[6, [12, 64]] = 1
    heads, cols = osd_disc.tep_positions(torch.as_tensor(t))
    assert heads.dtype == torch.int32 and cols.dtype == torch.int16
    assert heads.shape == (40, 4) and int(heads[0, 0]) == 0
    for r in range(40):
        o, n, c01, c2 = heads[r].tolist()
        want = np.flatnonzero(t[r])
        assert n == len(want)
        np.testing.assert_array_equal(cols[o:o + n].numpy(), want)
        head = [c01 & 0xFFFF, c01 >> 16, c2][:min(n, 3)]
        assert head == want[:3].tolist()
        assert [c01 & 0xFFFF, c01 >> 16, c2][min(n, 3):] == [0] * (3 - min(n, 3))
    assert cols[int(heads[5, 0]):int(heads[5, 0]) + 3].tolist() == [0, 33, 69]
    assert heads[:, 1].sum() == int(t.sum()) == cols.numel()
    empty, none = osd_disc.tep_positions(torch.zeros((3, 8), dtype=torch.int8))
    assert empty.tolist() == [[0, 0, 0, 0]] * 3 and none.numel() == 0


def test_block_minima_reference_ties_empty_blocks_and_ntot():
    """The plain twin's reduction, on a given discrepancy map: negative
    values below positive, ``_BIG`` a value like any other, the lowest
    index on a tie (-0 and +0 tie), an empty block (``_BIG``, 0), TEPs in
    no block or at or past ``ntot`` skipped, argmins less the block's
    start."""
    big = engine._BIG
    vals = torch.tensor([[3.0, -1.5, -0.0, 0.0, big, -1.5, 2.5, 0.0, -0.0, -9.0],
                         [0.0, -0.0, 7.0, -2.0, big, -2.0, -3e-30, -1e30, 1e-30,
                          -9.0]], dtype=torch.float32)
    b, n = vals.shape
    zeros = torch.zeros((b, 4), dtype=torch.float32)
    # blocks [0, 2) [2, 4) [4, 5) [5, 5) [5, 8) [8, 9); TEP 9 in no block
    starts = torch.tensor([0, 2, 4, 5, 5, 8])
    block_of = torch.tensor([0, 0, 1, 1, 2, 4, 4, 4, 5, -1], dtype=torch.int32)

    def reduce(ntot, owner=block_of):
        return osd_disc.block_minima_reference(
            None, None, torch.zeros(b), zeros, torch.zeros((n, 4), dtype=torch.int8),
            owner, starts, ntot, vals)

    minima, argmins = reduce(n)
    assert minima.dtype == torch.float32 and argmins.dtype == torch.int64
    assert torch.equal(minima, torch.tensor(
        [[-1.5, 0.0, big, big, -1.5, 0.0], [0.0, -2.0, big, big, -1e30, 1e-30]],
        dtype=torch.float32))
    assert argmins.tolist() == [[1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 2, 0]]
    assert argmins[0, 1] == 0  # -0.0 at 2 and +0.0 at 3 tie: 2 wins
    assert (minima[:, 3] == big).all() and (argmins[:, 3] == 0).all()  # empty
    # TEPs at or past ntot are skipped: block 4 keeps TEP 5 alone, 5 none
    minima, argmins = reduce(6)
    assert torch.equal(minima[:, 4], vals[:, 5]) and (argmins[:, 4] == 0).all()
    assert (minima[:, 5] == big).all() and (argmins[:, 5] == 0).all()
    # a hole in a block (a masked TEP): the rest of the block still counts
    holes = block_of.clone()
    holes[5] = -1
    minima, argmins = reduce(n, holes)
    assert minima[0, 4] == 0.0 and argmins[0, 4] == 2
    assert minima[1, 4] == -1e30 and argmins[1, 4] == 2


def test_minima_tables_of_a_chunked_layout():
    """``TepLayout`` holds the chunks, the cumulative sizes and K5's tables:
    each TEP's block (-1 past the last), the blocks' starts, the position
    lists; built from a path as from its blocks."""
    blocks = _random_blocks(np.random.default_rng(2), [3, 0, 40, 9], 16, 2)
    layout = segments.TepLayout.from_blocks(blocks, "cpu", chunk=16)
    teps, mask, bounds = segments.pack_tep_chunks(blocks, chunk=16)
    np.testing.assert_array_equal(layout.teps.numpy(), teps)
    np.testing.assert_array_equal(layout.mask.numpy(), mask)
    assert layout.bounds == bounds and layout.acc.tolist() == [0, 3, 3, 43, 52]
    assert layout.acc.dtype == torch.int64
    assert layout.ntot == 52 and layout.starts.tolist() == [0, 3, 3, 43]
    assert layout.starts.dtype == torch.int64
    want = np.full(64, -1)
    for p, (s, e) in enumerate(bounds):
        want[s:e] = p
    assert layout.block_of.dtype == torch.int32
    np.testing.assert_array_equal(layout.block_of.numpy(), want)
    assert layout.flat.data_ptr() == layout.teps.data_ptr()
    heads, cols = osd_disc.tep_positions(layout.flat)
    assert torch.equal(layout.positions[0], heads)
    assert torch.equal(layout.positions[1], cols)
    path = [[0] * 6, [1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0]]
    built = segments.TepLayout.build(path, 64, 6, "cpu", chunk=32)
    blocks, acc = segments.build_tep_blocks(path, 64, 6)
    again = segments.TepLayout.from_blocks(blocks, "cpu", chunk=32)
    assert built.bounds == again.bounds and built.acc.tolist() == acc.tolist()
    for name in ("teps", "mask", "block_of", "starts"):
        assert torch.equal(getattr(built, name), getattr(again, name)), name


def test_sliding_osd_walks_on_the_tables_it_is_given(monkeypatch):
    """``sliding_osd`` walks on the layout's tables: after the layout is
    built no position list is made again (``osd_disc.tep_positions``
    forbidden), and the walk's minima, complexity and selection are those
    of the unfused minima over the same blocks."""
    prep, blocks, k, chunk, _ = _minima_case("straddle")
    layout = segments.TepLayout.from_blocks(blocks, "cpu", chunk=chunk)
    prep = dataclasses.replace(prep, truth_discrepancy=torch.zeros(
        prep.m_matrix.shape[0]), order_labels=prep.hard_updated)
    w1, w2 = _fcn(3)
    fcn = {"w1": torch.as_tensor(w1), "w2": torch.as_tensor(w2)}
    acc = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
    want_min, want_arg = _unfused_minima(prep, layout, k)
    walk = engine.sliding_walk(want_min, fcn)

    def forbidden(*args, **kwargs):
        raise AssertionError("sliding_osd built position lists again")

    monkeypatch.setattr(osd_disc, "tep_positions", forbidden)
    got = engine.sliding_osd(prep, layout, fcn, k)
    assert torch.equal(got["block_minima"], want_min)
    for key in ("deep_limit", "global_min", "window_num", "windows_evaluated"):
        assert torch.equal(got[key], walk[key]), key
    np.testing.assert_array_equal(got["complexity"].numpy(),
                                  acc[walk["deep_limit"].numpy()])
    in_walk = torch.arange(want_min.shape[1])[None] < walk["deep_limit"][:, None]
    best = engine.first_argmin(torch.where(in_walk, want_min, engine._BIG), 1)
    flat = np.concatenate(blocks)
    sel = flat[acc[best.numpy()] + want_arg[torch.arange(len(best)), best].numpy()]
    want_strict = engine._selected_is_label(prep, torch.as_tensor(sel), k)
    assert torch.equal(got["strict_success"], want_strict)


@pytest.mark.parametrize("shape,blocks", [
    ((32768, 64, 64, 1536), 30),  # the main path
    ((1024, 176, 880, 102912), 15),  # the WiMAX round
    ((4096, 64, 64, 40000), 7),  # resident, the frame split across tiles
    ((400, 192, 192, 58368), 50), ((5, 61, 100, 130), 3)],
    ids=lambda s: "x".join(map(str, s)) if isinstance(s, tuple) else str(s))
def test_block_minima_plan_holds_keys_and_u_m(shape, blocks):
    """A block-minima plan is lterm's with room for the epilogue: on the
    resident plan two buffers of P keys and each frame buffer's u_m, on the
    general plan the frame's u_m; the tiles as lterm's where that still
    fits."""
    b, m, k, ntot = shape
    plan = osd_disc.lterm_plan(b, m, k, ntot, blocks=blocks)
    base = osd_disc.lterm_plan(b, m, k, ntot)
    assert plan.blocks == blocks and plan.smem_bytes <= 232_448
    if plan.resident:
        assert plan.smem_bytes == (plan.stride * plan.nt + plan.nbuf * (
            plan.stride * plan.m_pad + 8 * plan.m_pad)
            + 16 * blocks + 4 * plan.nbuf * plan.k_pad)
        assert plan.nt * plan.n_tiles >= ntot
    else:
        assert plan.smem_bytes == (1024 + 2 * plan.stages * (64 * plan.stride + 16)
                                   + plan.m_pad * plan.k_pad + 8 * plan.m_pad
                                   + 4 * plan.k_pad)
        assert plan.stages >= osd_disc.MIN_STAGES
    if shape == (32768, 64, 64, 1536):  # every TEP in one tile: direct minima
        assert (plan.nt, plan.n_tiles, plan.nbuf, plan.grid) == (
            1536, 1, 2, (132, 1))
    if shape == (1024, 176, 880, 102912):
        assert (plan.stages, plan.nt, plan.n_tiles, plan.grid) == (
            base.stages, base.nt, base.n_tiles, base.grid)
    if shape == (4096, 64, 64, 40000):
        assert plan.n_tiles > 1  # the device keys
