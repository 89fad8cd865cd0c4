"""``run_nms_mc`` and ``system.phase1_throughput`` of the port on the CPU:
error budget, resume, the overflowed step redone one-shot, failure capture
against JAX's helpers, launch counting and the CUDA default device."""

import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.mc import harness as jharness
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu_torch import _kernels, system
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import mc_cascade, nms_edge
from short_ldpc_decoding_osd_tpu_torch.utils.metrics import DecodeStats
from torch_mc_common import _kseed, _params

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


# --- run_nms_mc -------------------------------------------------------------

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


@pytest.mark.parametrize("rung", [None, "xla"], ids=["fused", "step"])
def test_run_nms_mc_resume_reproduces(rung, tmp_path):
    code = get_code("ccsds_128_64")
    variant = "NMS-1"
    kw = dict(batch=256, error_budget=10**6, max_frames=3 * 256, seed=4,
              rung=rung, device="cpu")
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
