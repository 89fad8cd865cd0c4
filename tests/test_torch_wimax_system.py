"""The WiMAX (1056,880) two-phase system on the port vs the JAX package (CPU).

The system of ``runs/r5_multicode/wimax_1056_880`` (NMS-1, 12 iterations,
``model_cnn`` DIA, window 5, soft margin 0.9, 6 segments) is the large-code
configuration of the JAX package's ``bench.py`` system loop
(``runs/r5_wimax_system/``).  Its full decoding path holds 102,786 TEPs; the
CPU twin of K5 materialises the (B, m, N) parity tensor, 74 GB at 1,024 rows,
so the phase-2 and system tests here cut the path to its first 8 patterns
(2,180 TEPs).  The full path runs on the card (``chip_smoke.py``'s "wimax
system" phase).
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu.pipeline.recipe import RunDir
from short_ldpc_decoding_osd_tpu_torch import convert, system
from short_ldpc_decoding_osd_tpu_torch.channel.awgn import sigma_for_snr
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import engine, segments
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIMAX = os.path.join(_ROOT, "runs", "r5_multicode", "wimax_1056_880")
CUT = 8  # patterns of the path kept on the CPU (2,180 TEPs)
SNR = 3.5
# the DIA's refined reliabilities, port vs JAX on one trajectory: f32
# convolutions summed in other orders
RTOL, ATOL = 1e-5, 1e-6
# through the whole step: K2's twin and JAX's XLA decoder sum in other
# orders, and over 12 iterations on failing frames their trajectories part
# by up to 1.8e-5 of max(|x|, 1) (measured on these rows), which the
# refined values carry (2.8e-5 absolute there)
STEP_TOL = 1e-4
WALK_KEYS = ("success", "strict_success", "complexity", "window_num")


def _layout(path, k):
    blocks, acc = segments.build_tep_blocks(path, k, 6)
    teps, mask, bounds = segments.pack_tep_chunks(blocks)
    return teps, mask, bounds, acc


def test_segments_full_path_match_jax():
    """The full path's TEP layout: 15 blocks, 102,786 TEPs in 402 chunks of
    256, the block bounds and the cumulative sizes equal to JAX's."""
    path = RunDir(WIMAX).load_json("decoding_path.json")["path"]
    teps, mask, bounds, acc = _layout(path, 880)
    jblocks, jacc = jseg.build_tep_blocks(path, 880, 6)
    jteps, jmask, jbounds = jseg.pack_tep_chunks(jblocks)
    assert teps.shape == (402, 256, 880) and teps.dtype == np.int8
    assert int(mask.sum()) == 102_786 and len(bounds) == 15
    assert bounds == jbounds and bounds[-1][1] == 102_786
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(teps, jteps)


@pytest.fixture(scope="module")
def wimax():
    run = RunDir(WIMAX)
    path = run.load_json("decoding_path.json")["path"][:CUT]
    port = convert.load_run(WIMAX, "cpu")
    code = port["code"]
    tep_layout = segments.TepLayout.build(path, code.k, 6, "cpu")
    # seeded AWGN rows at 3.5 dB (the raw-sample LLR proxy), failures of
    # the port's K1 twin first, as the capture step orders them
    rng = np.random.default_rng(35)
    msgs = rng.integers(0, 2, (256, code.k))
    words = (msgs @ code.g.astype(np.int64) % 2).astype(np.int32)
    received = 1.0 + rng.normal(0.0, sigma_for_snr(SNR, code.rate), words.shape)
    llr = np.where(words == 0, received, -received).astype(np.float32)
    soft = nms_edge.decode_final_edge(port["nms_params"], code.h,
                                      torch.as_tensor(llr), 12)
    failed = nms.frame_stats(soft, torch.as_tensor(words), code.h)[
        "detected_failure"].numpy()
    rows = np.argsort(~failed, kind="stable")[:64]
    return {
        "port": port, "layout": tep_layout, "teps": tep_layout.teps.numpy(),
        "mask": tep_layout.mask.numpy(), "bounds": tep_layout.bounds,
        "acc": tep_layout.acc.numpy(),
        "llr": llr[rows], "labels": words[rows], "failures": int(failed[rows].sum()),
        "jax_nms": run.load_pickle("nms_params.pkl"),
        "jax_dia": run.load_pickle("dia_model_cnn.pkl"),
        "jax_fcn": jdia.stopper_engine_params(run.load_pickle("stopper_params.pkl")),
    }


def test_cut_path_size(wimax):
    assert int(wimax["mask"].sum()) == 2_180 and len(wimax["bounds"]) == CUT


@pytest.fixture(scope="module")
def jax_phase2(wimax):
    """JAX's phase-2 step with its bit-exact XLA decoder on the 64 rows:
    (outputs, refined, detected), and JAX's (T+1, B, n) trajectory."""
    code = wimax["port"]["code"]
    jstep = jengine.make_dl_osd_step_from_llr(
        jdia.make_dia("model_cnn", code.n, 13), jax_get_code(code.name),
        "NMS-1", 12, bounds=wimax["bounds"], decoder="xla")
    out = jstep(
        wimax["jax_nms"], wimax["jax_dia"], jnp.asarray(wimax["llr"]),
        jnp.asarray(wimax["labels"]), jnp.asarray(wimax["teps"]),
        jnp.asarray(wimax["mask"]), jnp.asarray(wimax["acc"], jnp.int32),
        wimax["jax_fcn"])
    jtraj = jnms.decode(wimax["jax_nms"], jnp.asarray(code.h, jnp.float32),
                        jnp.asarray(wimax["llr"]), 12, "NMS-1")
    return out, np.array(jtraj)


def _refine(port, traj):
    with torch.no_grad():
        return port["dia"].refine_fast(
            torch.as_tensor(traj).permute(1, 0, 2)).numpy()


def test_phase2_matches_jax(wimax, jax_phase2):
    """The port's phase-2 step (K2's twin, ``refine_fast``, ``prepare``, the
    walk) against JAX's with its bit-exact XLA decoder on the same 64 rows:
    decisions and detected flags equal; the DIA's refined reliabilities on
    JAX's trajectory within rtol 1e-5, atol 1e-6, the step's own within
    rtol and atol ``STEP_TOL``."""
    assert wimax["failures"] >= 16
    port = wimax["port"]
    code = port["code"]
    (ref, ref_refined, ref_det), jtraj = jax_phase2
    step = engine.make_dl_osd_step_from_llr(
        port["dia"], code, "NMS-1", 12, wimax["layout"])
    got, refined, det = step(
        port["nms_params"], torch.as_tensor(wimax["llr"]),
        torch.as_tensor(wimax["labels"]), port["fcn"])
    for key in WALK_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)
    np.testing.assert_array_equal(det.numpy(), np.asarray(ref_det))
    assert int(det.sum()) == wimax["failures"]
    np.testing.assert_allclose(_refine(port, jtraj), np.asarray(ref_refined),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(refined.detach().numpy(), np.asarray(ref_refined),
                               rtol=STEP_TOL, atol=STEP_TOL)


def test_step_tol_separates_a_lagged_redecode(wimax, jax_phase2):
    """``STEP_TOL`` still catches a wrong re-decode: JAX's trajectory lagged
    by one iteration (slot t holds iteration t - 1, as a decoder that ran
    one iteration fewer would give) refines to values that miss JAX's
    step by far more than ``STEP_TOL``."""
    (_, ref_refined, _), jtraj = jax_phase2
    lagged = np.concatenate([jtraj[:1], jtraj[:-1]])
    gap = np.abs(_refine(wimax["port"], lagged) - np.asarray(ref_refined))
    allowed = STEP_TOL * (1.0 + np.abs(np.asarray(ref_refined)))
    assert (gap > allowed).any()
    assert gap.max() > 100 * STEP_TOL


def test_run_two_phase_on_cpu(tmp_path):
    """``run_two_phase`` on the WiMAX run directory with its path cut to 8
    patterns (the CPU twin of K5 materialises (B, m, N)): 2 rounds of 128
    frames at 3.5 dB, 32 capture rows a round."""
    run_dir = tmp_path / "wimax_1056_880"
    shutil.copytree(WIMAX, run_dir)
    with open(run_dir / "decoding_path.json") as fh:
        blob = json.load(fh)
    blob["path"] = blob["path"][:CUT]
    with open(run_dir / "decoding_path.json", "w") as fh:
        json.dump(blob, fh)
    out = system.run_two_phase(str(run_dir), frames=256, cap_b=128, cap=32,
                               snr_db=SNR, device="cpu")
    assert out["system_frames"] == 256 and out["system_snr_db"] == SNR
    assert out["system_osd_rows_walked"] == 64
    assert 0 < out["system_failures"] <= out["system_frame_errors"]
    assert 0 <= out["system_osd_success"] <= out["system_failures"]
    assert out["system_osd_strict_success"] <= out["system_failures"]
    assert set(out["system_split_s"]) == {"phase1_nms_capture_only",
                                          "two_phase_total", "phase2_implied"}
    assert set(out["system_stage_s"]) == {
        "capture_step_k1", "traj_redecode_k2", "frame_stats", "dia_refine_fast",
        "prepare_sort_ge", "disc_minima_k5", "stopper_walk", "sliding_osd_total"}
    json.dumps(out)
