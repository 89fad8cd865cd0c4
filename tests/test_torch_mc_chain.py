"""K4 and K3 of the port (their plain twins on the CPU) vs goldens built
from the numpy sampler and JAX's XLA decoder, K3's launch chain vs the
literal rule, a resumed plain decode vs one from scratch, and the host's
launch plan for every packaged code (see ``torch_mc_common`` for why the
JAX kernels themselves cannot run here; the resumed chain against the
golden is ``test_torch_mc_resume.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import mc_cascade, nms, nms_edge
from torch_mc_common import ATOL, _golden, _params

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


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

