"""The port's fused ENMS step against the benchmark's plain ENMS reference
(``gpubench/reference/variants/ENMS.py``, which imports nothing of the
port), on the CPU at small batches.

ENMS is NMS-1 on the extended parity matrix (``Code.extended``): H and
the pairwise sums of its rows of weight at most ``2 dc - 4``.  The fused
Monte-Carlo step decodes on it: K3's twins (the chain of STAGE, rank and
resumed COUNT, and the literal compaction rule the CPU runs) and K4's
twin count exactly what the reference's counters rule counts, on
``qc_96_48``'s extended matrix (240 x 96, bucket 3) and WiMAX's
(220 x 1,056, bucket 4), under two schedules.  Min, submin and the sign
product do not depend on order and the variable sums keep the ascending
check order of ``codes.edges``, so the counters are exact.  Decoding H in
ENMS's place counts otherwise.
"""

import numpy as np
import pytest
import torch

from gpubench import core
from gpubench.reference import codes, decode, judge, sampling
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness, ladder
from short_ldpc_decoding_osd_tpu_torch.ops import mc_dense, mc_hash, nms, nms_edge

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

DEC = core.decoder("ENMS")
ITERS = 12
SEED = 2**31 + 2929
SCHEDULES = (nms_edge.DEFAULT_COMPACT_SCHEDULE, ((2, 0.25), (3, 0.125)))
# (code, SNR, frames, group): every case has frame errors, and WiMAX's
# small groups overflow under the second schedule
CASES = {"qc_96_48": (2.5, 2048, 512), "wimax_1056_880": (3.5, 512, 128)}


def _params(seed=0):
    """ENMS's parameters with a check factor off its initial value."""
    p = nms.init_params("ENMS")
    return {k: v + 0.1 * (seed + 1) for k, v in p.items()}


def _ref(code, params, snr_db):
    h = np.array(code.h, np.uint8)
    return {"tables": decode.Tables(h, *codes.edges(h), torch.device("cpu")),
            "weights": DEC.weights({k: v.numpy() for k, v in params.items()}),
            "g": torch.as_tensor(codes.generator(h), dtype=torch.float32),
            "sigma": sampling.sigma_for_snr(snr_db, code.k / code.n)}


def _reference(ref, batch, seed, schedule, block):
    """The reference's six counters of the hash frames ``0..batch-1``."""
    fid = torch.arange(batch, dtype=torch.int64)
    codeword, llr = sampling.hash_frames(fid, seed, ref["g"], ref["sigma"])
    return DEC.counters(codeword, llr, ref, ITERS, schedule, block)[0]


@pytest.mark.parametrize("name", ["ccsds_128_64", "qc_96_48", "wimax_1056_880"])
def test_extend_is_the_ports_rule(name):
    code = get_code(name)
    np.testing.assert_array_equal(DEC.extend(code.h), code.extended().h)


def test_wimax_extended_shape():
    h = DEC.extend(get_code("wimax_1056_880").h)
    assert h.shape == (220, 1056) and int(h.sum()) == 5104
    degrees, counts = np.unique(h.sum(1), return_counts=True)
    assert degrees.tolist() == [20, 36] and counts.tolist() == [176, 44]
    assert int(h.sum(0).max()) == 6


@pytest.mark.parametrize("schedule", SCHEDULES, ids=["one_stage", "two_stages"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_enms_step_is_the_reference(name, schedule):
    """K3's twins (the chain and the literal rule) and K4's equal the
    reference's counters exactly."""
    code = get_code(name)
    snr, batch, block = CASES[name]
    params = _params()
    mc = nms_edge.mc_setup(code, params, "ENMS", snr, SEED, "cpu")
    assert mc.extended and np.array_equal(mc.h, code.extended().h)
    ref = _ref(code, params, snr)
    want = _reference(ref, batch, mc.seed, schedule, block)
    rows, final = nms_edge.build_rows_schedule(schedule, block, ITERS)
    chain = nms_edge._compact_chain(mc, batch, block, rows, final,
                                    frames_fn=nms_edge._mc_frames_plain,
                                    rank_fn=nms_edge._group_rank_plain)
    assert chain.tolist() == want and want[1] > 0
    got = nms_edge.fused_counters_edge_compact(
        code, params, "ENMS", ITERS, snr, batch, SEED, block_frames=block,
        schedule=schedule, device="cpu")
    assert got.tolist() == want
    oneshot = nms_edge.fused_counters_edge(code, params, "ENMS", ITERS, snr,
                                           batch, SEED, device="cpu")
    assert oneshot.tolist() == _reference(ref, batch, mc.seed, (), block)[:5]


def test_wimax_second_schedule_overflows():
    """The cases above cover the overflow lane on WiMAX."""
    code = get_code("wimax_1056_880")
    snr, batch, block = CASES["wimax_1056_880"]
    got = nms_edge.fused_counters_edge_compact(
        code, _params(), "ENMS", ITERS, snr, batch, SEED, block_frames=block,
        schedule=SCHEDULES[1], device="cpu")
    assert got[5] > 0


def test_h_in_enms_place_reads_a_mismatch():
    """The planted fault: K3's twin decoding H with ENMS's weights, as a
    set-up that ignored the variant would, reads ``counter_mismatch`` > 0
    against the reference; the port's ENMS step reads 0."""
    code = get_code("wimax_1056_880")
    snr, batch, block = 4.0, 1024, 512
    params = _params()
    schedule = nms_edge.DEFAULT_COMPACT_SCHEDULE
    want = _reference(_ref(code, params, snr),
                      batch, SEED & 0xFFFFFFFF, schedule, block)
    rows, final = nms_edge.build_rows_schedule(schedule, block, ITERS)
    got = nms_edge.fused_counters_edge_compact(
        code, params, "ENMS", ITERS, snr, batch, SEED, block_frames=block,
        schedule=schedule, device="cpu")
    assert judge.counter_mismatch(got.tolist(), want) == 0
    on_h = nms_edge.mc_setup(code, params, "NMS-1", snr, SEED, "cpu")
    assert on_h.weights == nms.scalar_weights(params, "ENMS")
    fault = nms_edge._compact_plain(on_h, batch, block, rows, final)
    assert judge.counter_mismatch(fault.tolist(), want) > 0


def test_mc_plan_of_the_wimax_extended_matrix():
    mc = nms_edge.mc_setup(get_code("wimax_1056_880"), _params(), "ENMS", 4.0,
                           1, "cpu")
    assert tuple(mc.edge_col.shape) == (36, 220)
    assert tuple(mc.var_edges.shape) == (6, 1056)
    # the split bucket: 264 segment lanes (44 checks of degree 36 on two
    # lanes each, 176 of degree 20 on one) of 288, 21-word segment rows
    assert mc.plan == nms_edge.LaunchPlan(bucket=nms_edge.SPLIT_BUCKET,
                                          warps=9, frames=1)
    assert nms_edge.split_lanes(mc.h) == 264
    words = nms_edge.region_words(4, 9 * 32, (880 + 31) // 32 + 2)
    assert words == 4 * 288 + 1 + 288 * 21 + 1 + 30
    assert 4 * (16 + words) <= nms_edge.SMEM_LIMIT


def test_run_nms_mc_fused_enms_equals_its_capture_route():
    """``run_nms_mc`` takes ENMS to the fused branch (K4's twin here, every
    step one-shot) and counts what the capture route's decoder (K1's twin
    on the extended matrix, ``count_and_capture``) counts on the same hash
    frames."""
    code = get_code("qc_96_48")
    params, snr, batch, seed = _params(1), 2.5, 512, 5
    stats, _ = harness.run_nms_mc(code, params, "ENMS", ITERS, snr, batch=batch,
                                  max_frames=2 * batch, seed=seed,
                                  rung="oneshot", device="cpu")
    decode_h = code.extended().h
    step = harness.decode_final_fn(
        harness.select_decoder(decode_h, "ENMS", batch, device="cpu"),
        decode_h, "ENMS", ITERS, torch.device("cpu"))
    mc = nms_edge.mc_setup(code, params, "ENMS", snr, 0, "cpu")
    total = 0
    for idx in range(2):
        words, llr = mc_hash.sample(torch.arange(batch), (seed * 100003 + idx)
                                    & 0x7FFFFFFF, mc.g32, mc.sigma)
        soft = step(params, llr)
        total = total + harness.count_and_capture(llr, words, soft,
                                                  decode_h)[0].numpy()
    assert [stats.frames, stats.frame_errors, stats.bit_errors,
            stats.detected_failures, stats.undetected_errors] == total.tolist()
    assert stats.frame_errors > 0
    # the default rung: K3's twin on the extended matrix, step by step (at
    # an SNR where no step overflows into the one-shot redo)
    snr = 4.0
    compact, _ = harness.run_nms_mc(code, params, "ENMS", ITERS, snr,
                                    batch=batch, max_frames=2 * batch,
                                    seed=seed, device="cpu")
    block, _ = ladder.ladder_blocks(batch, ITERS, 4)
    want = sum(nms_edge.fused_counters_edge_compact(
        code, params, "ENMS", ITERS, snr, batch, (seed * 100003 + idx)
        & 0x7FFFFFFF, block_frames=block,
        schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device="cpu").numpy()
        for idx in range(2))
    assert want[5] == 0 and want[1] > 0
    assert [compact.frames, compact.frame_errors, compact.bit_errors,
            compact.detected_failures, compact.undetected_errors] == want[:5].tolist()


def test_ccsds_enms_is_nms1_on_the_fused_step():
    """CCSDS's extended matrix is H itself: ENMS counts as NMS-1."""
    code = get_code("ccsds_128_64")
    params = _params()
    got = [nms_edge.fused_counters_edge_compact(
        code, params, v, ITERS, 3.0, 2048, SEED, device="cpu").tolist()
        for v in ("ENMS", "NMS-1")]
    assert got[0] == got[1] and got[0][1] > 0


@pytest.mark.parametrize("name", ["qc_96_48", "wimax_1056_880"])
def test_dense_rung_refuses_enms(name):
    """K7 holds neither extended matrix: the pinned rung raises, naming
    ENMS, and decodes nothing in its place."""
    code = get_code(name)
    with pytest.raises(ValueError, match="ENMS"):
        harness.run_nms_mc(code, _params(), "ENMS", ITERS, 3.0, batch=64,
                           max_frames=64, rung="dense", device="cpu")
    with pytest.raises(ValueError, match="ENMS"):
        mc_dense.fused_counters(code, _params(), "ENMS", ITERS, 3.0, 64, 1,
                                device="cpu")
