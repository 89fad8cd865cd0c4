"""Phase-1 Monte-Carlo path of the port vs the JAX package (CPU).

The hash sampler (``ops/mc_hash.py``) is held bit for bit against a numpy
golden and against JAX's ``mc_cascade._mix``/``_stream_bits``/``_sample``
run through a tiny interpret-mode Pallas kernel; normals agree to 1e-5
(measured worst 1.32e-6 against the f64 golden and 2.4e-7 against JAX: the
f32 uniforms and 2 pi u2 round before the transcendentals, which the port
evaluates in f64 on the CPU).

K8 (``cascade_counters``) is held against JAX's interpret-mode K8 Pallas
kernels.  The JAX side of K3 and K4 cannot run here: those Pallas kernels
draw from the TPU's on-core PRNG, which has no CPU interpret lowering.  So
the port's K3 and K4 (which draw from the hash sampler instead) are held
against goldens built from the numpy sampler and JAX's XLA decoder
(``nms.decode``), with the compaction rule written out in numpy.  Counter
tolerance is 2 frames throughout, the tolerance of
``tests/test_mc_cascade.py``: f32 rounding differences between decoders on
razor-edge soft values can flip a frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.channel import sigma_for_snr
from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.mc import harness as jharness
from short_ldpc_decoding_osd_tpu.ops import mc_cascade as jcascade
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.ops import nms_edge_pallas as jedge
from short_ldpc_decoding_osd_tpu_torch import _kernels, system
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import mc_cascade, mc_hash, nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.utils.metrics import DecodeStats

_MASK = np.uint64(0xFFFFFFFF)
ATOL = 2


# --- numpy golden of the hash sampler (as tests/test_mc_cascade.py) -------

def _mix_np(x):
    """numpy golden of mc_cascade._mix (uint64 carrier, 32-bit wrap)."""
    x = x.astype(np.uint64) & _MASK
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & _MASK
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & _MASK
    x ^= x >> np.uint64(16)
    return x & _MASK


def _sample_np(fids, seed, code, sigma, mean=1.0):
    """numpy golden of mc_cascade._sample (exact integer path; f64 waveform)."""
    n, k = code.n, code.k
    gold1 = np.uint64(np.uint32(jcascade._GOLD1))
    gold2 = np.uint64(np.uint32(jcascade._GOLD2))
    base = _mix_np((fids.astype(np.uint64) * gold1 + np.uint64(seed)) & _MASK)
    streams = np.arange(1, k + 1, dtype=np.uint64)
    words = _mix_np(base[:, None] ^ ((streams[None, :] * gold2) & _MASK))
    msg = (words & np.uint64(1)).astype(np.int64)
    codeword = (msg @ code.g.astype(np.int64)) % 2
    sn = np.arange(n, dtype=np.uint64)
    w1 = _mix_np(base[:, None] ^ (((sn + np.uint64(k + 1)) * gold2) & _MASK))
    w2 = _mix_np(base[:, None] ^ (((sn + np.uint64(k + 1 + n)) * gold2) & _MASK))
    u1 = (w1 >> np.uint64(8)).astype(np.float64) / 16777216.0 + 0.5 / 16777216.0
    u2 = (w2 >> np.uint64(8)).astype(np.float64) / 16777216.0 + 0.5 / 16777216.0
    z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    llr = (1.0 - 2.0 * codeword) * (mean + sigma * z)
    return codeword, llr, words


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


# --- the compaction rule written out over JAX's XLA decoder --------------

def _golden(code_name, seed, batch, num_iterations, snr_db=3.0, stages=(),
            block=None):
    """Counters [frames, frame_err, bit_err, detected, undetected] and the
    overflow count of the hash frames ``0..batch-1`` under the rule: at each
    stage ``(cumulative iterations, rows)`` a frame with a zero syndrome is
    judged there, and of each ``block`` group's alive unconverged frames
    (frame order) those ranked >= rows are judged there too (overflow);
    the rest go on; frames alive at the end are judged at T."""
    code = jax_get_code(code_name)
    h = code.h.astype(np.int64)
    sigma = float(sigma_for_snr(snr_db, code.rate))
    codeword, llr, _ = _sample_np(np.arange(batch), seed, code, sigma)
    outs = np.asarray(jnms.decode(jnms.init_params("NMS-1"),
                                  jnp.asarray(code.h, jnp.float32),
                                  jnp.asarray(llr, jnp.float32),
                                  num_iterations, "NMS-1"))
    decision = outs[num_iterations] < 0
    alive = np.ones(batch, bool)
    overflow = 0
    for cum_iters, rows in stages:
        hard = outs[cum_iters] < 0
        unconv = (hard.astype(np.int64) @ h.T % 2).any(axis=1)
        u = (alive & unconv).reshape(-1, block)
        rank = np.cumsum(u, axis=1) - u
        covered = (u & (rank < rows)).ravel()
        judged = alive & ~covered
        decision[judged] = hard[judged]
        overflow += int((alive & unconv & ~covered).sum())
        alive = covered
    err = decision != codeword
    frame_err = err.any(axis=1)
    synd = (decision.astype(np.int64) @ h.T % 2).any(axis=1)
    counters = np.array([batch, frame_err.sum(), err.sum(),
                         (frame_err & synd).sum(), (frame_err & ~synd).sum()])
    return counters, overflow


def _params():
    return nms.init_params("NMS-1")


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


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "wimax_1056_880"])
def test_gen_columns_encode(code_name):
    """The kernels' encode operand: popcount(msg & column mask) & 1 equals
    msg @ G mod 2, also for k > 32 words (WiMAX k = 880)."""
    code = get_code(code_name)
    cols = nms_edge.gen_columns(code.g).view(np.uint32)
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, (16, code.k))
    kw = cols.shape[1]
    padded = np.zeros((16, kw * 32), np.uint64)
    padded[:, : code.k] = msg
    words = (padded.reshape(16, kw, 32)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    anded = words[:, None, :] & cols[None]  # (16, n, kw)
    parity = np.unpackbits(anded.view(np.uint8), axis=-1).sum(-1) % 2
    np.testing.assert_array_equal(parity, msg @ code.g.astype(np.int64) % 2)


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


# --- K8 against the Pallas kernels (interpret mode) --------------------------

def test_cascade_matches_jax_pallas():
    code, jcode = get_code("ccsds_128_64"), jax_get_code("ccsds_128_64")
    batch, t1, T, seed = 1024, 4, 8, 11
    ref = np.asarray(jcascade.cascade_counters(
        jcode, jnms.init_params("NMS-1"), "NMS-1", T, 3.0, batch, seed, t1=t1,
        block_frames=256, mode="highest", interpret=True))
    got = mc_cascade.cascade_counters(code, _params(), "NMS-1", T, 3.0, batch,
                                      seed, t1=t1, block_frames=256, device="cpu")
    assert got.dtype == torch.int64 and int(got[0]) == batch
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    want, _ = _golden("ccsds_128_64", seed, batch, T, stages=((t1, batch),),
                      block=batch)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cascade_overflow_retry(monkeypatch):
    """A calibration cache poisoned with share 0 gives a capacity far below
    the flagged frames: the retry doubles it until every frame is counted,
    with the counters of an ample capacity.  The case of
    tests/test_mc_cascade.py (1.0 dB, t1 = 2, T = 6) against JAX too."""
    code = get_code("ccsds_128_64")
    args = (code, _params(), "NMS-1", 6, 1.0, 512, 5)
    kw = dict(t1=2, block_frames=128, device="cpu")
    monkeypatch.setattr(mc_cascade, "_CAP_CACHE", {})
    ample = mc_cascade.cascade_counters(*args, **kw)
    key = next(iter(mc_cascade._CAP_CACHE))
    assert mc_cascade._CAP_CACHE[key] > 0.5  # most frames unconverged at t1
    mc_cascade._CAP_CACHE[key] = 0.0
    calls = []
    phase2 = mc_cascade.phase2
    monkeypatch.setattr(mc_cascade, "phase2",
                        lambda mc, t, ids: calls.append(len(ids)) or phase2(mc, t, ids))
    poisoned = mc_cascade.cascade_counters(*args, **kw)
    assert calls == [384, 512]  # 6 + 2 * 128 rounded up, then doubled (<= batch)
    assert int(poisoned[0]) == 512
    np.testing.assert_array_equal(poisoned.numpy(), ample.numpy())
    ref = np.asarray(jcascade.cascade_counters(
        jax_get_code("ccsds_128_64"), jnms.init_params("NMS-1"), "NMS-1", 6,
        1.0, 512, 5, t1=2, block_frames=128, mode="highest", interpret=True))
    np.testing.assert_allclose(poisoned.numpy(), ref, atol=ATOL)


# --- K4 and K3 against JAX-decoder goldens -----------------------------------

@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48"])
def test_oneshot_matches_jax_decoder(code_name):
    got = nms_edge.fused_counters_edge(get_code(code_name), _params(), "NMS-1",
                                       8, 3.0, 1024, 13, device="cpu")
    want, _ = _golden(code_name, 13, 1024, 8)
    assert got.shape == (5,) and int(got[0]) == 1024
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_compact_ample_capacity_matches_golden_and_cascade():
    code = get_code("ccsds_128_64")
    got = nms_edge.fused_counters_edge_compact(
        code, _params(), "NMS-1", 8, 3.0, 1024, 11, t1=4, block_frames=512,
        schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device="cpu")
    assert int(got[5]) == 0
    want, overflow = _golden("ccsds_128_64", 11, 1024, 8, stages=((4, 208),),
                             block=512)
    assert overflow == 0
    np.testing.assert_allclose(got[:5].numpy(), want, atol=ATOL)
    cascade = mc_cascade.cascade_counters(code, _params(), "NMS-1", 8, 3.0, 1024,
                                          11, t1=4, device="cpu")
    np.testing.assert_array_equal(got[:5].numpy(), cascade.numpy())


@pytest.mark.parametrize("schedule,block,stages", [
    (((2, 0.125),), 128, ((2, 64),)),  # forced overflow
    (((2, 0.5), (2, 0.25)), 256, ((2, 128), (4, 64))),  # two stages
], ids=["forced_overflow", "two_stage"])
def test_compact_rank_rule_matches_golden(schedule, block, stages):
    got = nms_edge.fused_counters_edge_compact(
        get_code("ccsds_128_64"), _params(), "NMS-1", 8, 2.0, 1024, 17,
        block_frames=block, schedule=schedule, device="cpu")
    want, overflow = _golden("ccsds_128_64", 17, 1024, 8, snr_db=2.0,
                             stages=stages, block=block)
    assert overflow > 0
    np.testing.assert_allclose(got.numpy(), list(want) + [overflow], atol=ATOL)


@pytest.mark.parametrize("schedule,block", [
    (nms_edge.DEFAULT_COMPACT_SCHEDULE, 512),
    (((2, 0.125),), 128),
    (((2, 0.5), (2, 0.25)), 256),
    (((4, 0.5),), 512),
])
def test_compact_chain_matches_literal_rule(schedule, block):
    """The launch chain the card runs (stage, rank, ..., count), here with
    every launch's plain twin, equals the literal rule exactly."""
    mc = nms_edge.mc_setup(get_code("ccsds_128_64"), _params(), "NMS-1", 2.0,
                           23, "cpu")
    rows, final = nms_edge.build_rows_schedule(schedule, block, 8)
    chain = nms_edge._compact_chain(mc, 1024, block, rows, final,
                                    nms_edge._mc_frames_plain,
                                    nms_edge._group_rank_plain)
    literal = nms_edge._compact_plain(mc, 1024, block, rows, final)
    np.testing.assert_array_equal(chain.numpy(), literal.numpy())


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48"])
@pytest.mark.parametrize("schedule,block,snr_db", [
    (((4, 0.375),), 1024, 3.0),  # bench.py's schedule
    (nms_edge.DEFAULT_COMPACT_SCHEDULE, 512, 3.0),
    (((4, 0.5), (2, 0.25)), 512, 2.0),  # two stages
    (((2, 0.125),), 128, 1.5),  # a capacity that overflows
], ids=["bench", "default", "two_stage", "overflow"])
def test_resumed_chain_matches_literal_rule_and_golden(code_name, schedule,
                                                       block, snr_db):
    """The launch chain as the card runs it, each stage resuming its frames
    from the messages the previous one saved, on the plain twins: equal to
    the literal rule (every frame decoded from scratch) counter for
    counter, and to the JAX-decoder golden within the tolerance."""
    batch, T, seed = 1024, 12, 19
    mc = nms_edge.mc_setup(get_code(code_name), _params(), "NMS-1", snr_db,
                           seed, "cpu")
    rows, final = nms_edge.build_rows_schedule(schedule, block, T)
    chain = nms_edge._compact_chain(mc, batch, block, rows, final,
                                    nms_edge._mc_frames_plain,
                                    nms_edge._group_rank_plain)
    literal = nms_edge._compact_plain(mc, batch, block, rows, final)
    np.testing.assert_array_equal(chain.numpy(), literal.numpy())
    stages, spent = [], 0
    for iters, cap in rows:
        spent += iters
        stages.append((spent, cap))
    want, overflow = _golden(code_name, seed, batch, T, snr_db=snr_db,
                             stages=tuple(stages), block=block)
    np.testing.assert_allclose(chain.numpy(), list(want) + [overflow],
                               atol=ATOL)
    if schedule == ((2, 0.125),):
        assert int(chain[5]) > 0


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48"])
def test_plain_decode_resumes_bit_for_bit(code_name):
    """A decode resumed from its messages after t iterations is, bit for
    bit, the decode from scratch of t + r iterations, and JAX's
    ``nms.decode`` within 1e-5."""
    code = get_code(code_name)
    rng = np.random.default_rng(29)
    llr = rng.normal(1.0, 0.9, (256, code.n)).astype(np.float32)
    x = torch.as_tensor(llr)
    weights = nms.scalar_weights(_params(), "NMS-1")
    t, r = 4, 8
    first, cv = nms_edge._decode_edge_plain(x, code.h, t, weights, False,
                                            return_cv=True)
    assert cv.shape == (256, nms_edge.edge_layout(code.h)[0].size)
    resumed = nms_edge._decode_edge_plain(x, code.h, r, weights, False, cv0=cv)
    scratch = nms_edge._decode_edge_plain(x, code.h, t + r, weights, False)
    assert torch.equal(resumed, scratch)
    assert not torch.equal(first, scratch)
    ref = np.asarray(jnms.decode(jnms.init_params("NMS-1"),
                                 jnp.asarray(code.h, jnp.float32),
                                 jnp.asarray(llr), t + r, "NMS-1"))[t + r]
    np.testing.assert_allclose(resumed.numpy(), ref, rtol=1e-5, atol=1e-5)
    # zero further iterations: the column sums of the saved messages
    again = nms_edge._decode_edge_plain(x, code.h, 0, weights, False, cv0=cv)
    assert torch.equal(again, first)


def _pr3_shape_accepts(code) -> bool:
    """The rule of the previous ``mc_frames_per_block``: the tables (dc m +
    dv n + 8 words) and one frame (dc m + 3 n + ceil(k/32) + 2 words) fit
    a block's 227 KB."""
    h = np.asarray(code.h, np.int64)
    m, n = h.shape
    dc, dv = int(h.sum(1).max()), int(h.sum(0).max())
    words = (dc * m + dv * n + 8) + (dc * m + 3 * n + (code.k + 31) // 32 + 2)
    return 4 * words <= 227 * 1024


@pytest.mark.parametrize("code_name", [
    "array_121_60", "array_121_80", "ccsds_128_64", "code1_64_32", "qc_96_48",
    "wimax_1056_880", "wimaxlike_384_192"])
def test_launch_plan_takes_every_packaged_code(code_name):
    """The host's choice of degree bucket and launch shape takes every
    packaged code the previous frame layout took, and the plan's lanes own
    every check and variable within the bucket's degrees."""
    code = get_code(code_name)
    assert _pr3_shape_accepts(code)
    h = np.asarray(code.h, np.int64)
    m, n = h.shape
    dc, dv = int(h.sum(1).max()), int(h.sum(0).max())
    for plan in (nms_edge.mc_setup(code, _params(), "NMS-1", 3.0, 1, "cpu").plan,
                 nms_edge.launch_plan(m, n, dc, dv)):
        assert plan is not None
        bdc, bdv, cpl, vpl = nms_edge.BUCKETS[plan.bucket]
        lanes = 32 * plan.warps
        assert dc <= bdc and dv <= bdv and m <= cpl * lanes and n <= vpl * lanes
        assert 1 <= plan.frames <= 15 and 32 * plan.warps * plan.frames <= 512
        # the smallest bucket that takes the degrees, the fewest warps
        assert all(dc > b[0] or dv > b[1] for b in nms_edge.BUCKETS[:plan.bucket])
        assert plan.warps == 1 or m > cpl * (lanes - 32) or n > vpl * (lanes - 32)
    assert nms_edge.kernel_holds(code.h)
    assert nms_edge.kernel_holds(code.extended().h)  # ENMS decodes on it
    want = {"ccsds_128_64": (0, 1, 4), "qc_96_48": (0, 1, 4),
            "array_121_60": (1, 2, 2), "wimax_1056_880": (2, 9, 1)}
    if code_name in want:
        assert (plan.bucket, plan.warps, plan.frames) == want[code_name]


def test_launch_plan_refuses_what_no_bucket_takes():
    assert nms_edge.launch_plan(64, 128, 41, 3) is None  # dc above every bucket
    assert nms_edge.launch_plan(64, 128, 8, 65) is None  # dv above every bucket
    assert nms_edge.launch_plan(64, 4 * 32 * 17, 8, 3) is None  # > 16 warps
    assert [nms_edge.launch_plan(64, 128, dc, dv).bucket for dc, dv in (
        (8, 3), (9, 3), (12, 6), (8, 7), (21, 3))] == [0, 1, 2, 3, 4]


def test_compact_refuses_ragged_batch():
    with pytest.raises(ValueError, match="multiple"):
        nms_edge.fused_counters_edge_compact(get_code("ccsds_128_64"), _params(),
                                             "NMS-1", 8, 3.0, 1000, 1,
                                             block_frames=512, device="cpu")


# --- run_nms_mc -------------------------------------------------------------

def _kseed(seed, idx):
    return (seed * 100003 + idx) & 0x7FFFFFFF


def test_run_nms_mc_error_budget_stops():
    code = get_code("ccsds_128_64")
    stats, failures = harness.run_nms_mc(code, _params(), "NMS-1", 8, 3.0,
                                         batch=256, error_budget=40, seed=3,
                                         device="cpu")
    assert failures is None
    # the same steps by hand: compact steps until the budget is exceeded
    want, idx = DecodeStats(bits_per_frame=code.n), 0
    while want.frame_errors <= 40:
        c = nms_edge.fused_counters_edge_compact(
            code, _params(), "NMS-1", 8, 3.0, 256, _kseed(3, idx),
            block_frames=256, schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE,
            device="cpu").numpy()
        assert c[5] == 0
        want = want.merge(DecodeStats(int(c[0]), int(c[1]), int(c[2]), code.n,
                                      int(c[3]), int(c[4])))
        idx += 1
    assert idx >= 2 and stats == want


@pytest.mark.parametrize("variant", ["NMS-1", "ENMS"], ids=["fused", "step"])
def test_run_nms_mc_resume_reproduces(variant, tmp_path):
    code = get_code("ccsds_128_64")
    kw = dict(batch=256, error_budget=10**6, max_frames=3 * 256, seed=4,
              device="cpu")
    whole, _ = harness.run_nms_mc(code, _params(), variant, 6, 2.5, **kw)
    path = str(tmp_path / "resume.json")
    first, _ = harness.run_nms_mc(code, _params(), variant, 6, 2.5,
                                  resume_path=path, **kw | {"max_frames": 256})
    assert first.frames == 256
    resumed, _ = harness.run_nms_mc(code, _params(), variant, 6, 2.5,
                                    resume_path=path, **kw)
    assert resumed == whole and whole.frames == 3 * 256


def test_run_nms_mc_overflow_redoes_oneshot(monkeypatch):
    """A compact step that overflows is redone one-shot on the same frames,
    and the sweep stays one-shot."""
    code = get_code("ccsds_128_64")
    calls = []
    compact, oneshot = nms_edge.fused_counters_edge_compact, nms_edge.fused_counters_edge

    def spy_compact(*a, **k):
        calls.append(("compact", k["seed"]))
        return compact(*a, **k)

    def spy_oneshot(*a, **k):
        calls.append(("oneshot", k["seed"]))
        return oneshot(*a, **k)

    monkeypatch.setattr(nms_edge, "DEFAULT_COMPACT_SCHEDULE", ((2, 0.125),))
    monkeypatch.setattr(nms_edge, "fused_counters_edge_compact", spy_compact)
    monkeypatch.setattr(nms_edge, "fused_counters_edge", spy_oneshot)
    stats, _ = harness.run_nms_mc(code, _params(), "NMS-1", 8, 1.5, batch=512,
                                  max_frames=3 * 512, seed=2, device="cpu")
    seeds = [_kseed(2, i) for i in range(3)]
    assert calls == [("compact", seeds[0]), ("oneshot", seeds[0]),
                     ("oneshot", seeds[1]), ("oneshot", seeds[2])]
    total = sum(oneshot(code, _params(), "NMS-1", 8, 1.5, 512, s,
                        device="cpu").numpy() for s in seeds)
    assert stats == DecodeStats(*[int(x) for x in total[:3]], code.n,
                                int(total[3]), int(total[4]))


def test_run_nms_mc_capture_matches_jax():
    code, jcode = get_code("ccsds_128_64"), jax_get_code("ccsds_128_64")
    stats, fb = harness.run_nms_mc(code, _params(), "NMS-1", 8, 2.5, batch=256,
                                   error_budget=40, capture_failures=True,
                                   capture_limit=32, seed=6, device="cpu")
    assert isinstance(fb, harness.FailureBatch) and fb.confirmed
    assert len(fb.labels) + fb.mismatches == 32 <= stats.detected_failures
    assert fb.overflow == stats.detected_failures - 32
    assert fb.trajectories.shape == (len(fb.labels), 9, code.n)
    # the two helpers against JAX's on the same numpy LLRs
    llrs = fb.trajectories[:, 0]
    jparams = jnms.init_params("NMS-1")
    ref = jharness.trajectories_for_llrs(jcode, jparams, "NMS-1", 8, llrs,
                                         chunk=32)
    got = harness.trajectories_for_llrs(code, _params(), "NMS-1", 8, llrs,
                                        device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, fb.trajectories)
    rng = np.random.default_rng(8)
    mixed = np.concatenate([got, rng.normal(1.0, 0.5, got.shape).astype(np.float32)])
    np.testing.assert_array_equal(harness.detected_failure_mask(code, "NMS-1", mixed),
                                  jharness.detected_failure_mask(jcode, "NMS-1", mixed))
    assert harness.detected_failure_mask(code, "NMS-1", got).all()


# --- the phase-1 headline entry ------------------------------------------------

def test_phase1_throughput_on_cpu():
    """Compact and one-shot decode the same hash frames: with no overflow
    their counters are equal."""
    runs = {kernel: system.phase1_throughput(batch=1024, steps=2, kernel=kernel,
                                             frac=0.5, block_frames=512,
                                             iters=8, device="cpu")
            for kernel in ("compact", "oneshot")}
    compact, oneshot = runs["compact"], runs["oneshot"]
    assert compact["timed_compact_overflow"] == 0
    for key in ("timed_frames", "timed_frame_errors", "timed_bit_errors",
                "timed_detected", "timed_undetected", "sample_fer"):
        assert compact[key] == oneshot[key]
    assert compact["timed_frames"] == 2048 and 0 < compact["sample_fer"] < 0.3
    assert compact["value"] > 0 and compact["device"] == "cpu"


def test_no_launch_counted_on_cpu():
    _kernels.reset_launches()
    nms_edge.fused_counters_edge(get_code("code1_64_32"), _params(), "NMS-1", 4,
                                 3.0, 64, 1, device="cpu")
    assert sum(_kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("entry", [
    lambda: nms_edge.fused_counters_edge(get_code("ccsds_128_64"), _params(),
                                         "NMS-1", 4, 3.0, 64, 1),
    lambda: nms_edge.fused_counters_edge_compact(get_code("ccsds_128_64"),
                                                 _params(), "NMS-1", 8, 3.0, 512, 1),
    lambda: mc_cascade.cascade_counters(get_code("ccsds_128_64"), _params(),
                                        "NMS-1", 8, 3.0, 512, 1),
    lambda: harness.run_nms_mc(get_code("ccsds_128_64"), _params(), "NMS-1", 8, 3.0),
    lambda: harness.trajectories_for_llrs(get_code("ccsds_128_64"), _params(),
                                          "NMS-1", 4, np.ones((2, 128), np.float32)),
    lambda: system.phase1_throughput(batch=1024, steps=1),
], ids=["fused_counters_edge", "fused_counters_edge_compact", "cascade_counters",
        "run_nms_mc", "trajectories_for_llrs", "phase1_throughput"])
def test_cuda_default_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
