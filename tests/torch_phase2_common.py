"""Shared helpers of the phase-2 parity tests: the port's raw-LLR phase-2
step (``engine.make_dl_osd_step_from_llr``) against JAX's with its bit-exact
XLA decoder on the same seeded rows of a committed run directory.

Rows are drawn with numpy (the raw-sample LLR proxy, optionally Rayleigh
block fading built as ``channel/awgn.py`` builds it) and the failures of the
port's K1 twin come first, as the capture step orders them.
"""

import jax.numpy as jnp
import numpy as np
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.pipeline.recipe import RunDir
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.channel.awgn import sigma_for_snr
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import engine, segments

WALK_KEYS = ("success", "strict_success", "complexity", "window_num")
# the DIA's refined reliabilities, port vs JAX on one trajectory: f32
# convolutions summed in other orders
RTOL, ATOL = 1e-5, 1e-6


def layout(path, k, num_segments=6):
    """The engine's TEP layout of a decoding path on the CPU (``layout``)
    and its ``teps``, ``mask``, ``bounds`` and ``acc`` as JAX's step takes
    them."""
    tep_layout = segments.TepLayout.build(path, k, num_segments, "cpu")
    return {"layout": tep_layout, "teps": tep_layout.teps.numpy(),
            "mask": tep_layout.mask.numpy(), "bounds": tep_layout.bounds,
            "acc": tep_layout.acc.numpy()}


def seeded_rows(code, snr_db, rows, seed, fade_block=None):
    """``rows`` (llr, codeword) pairs at ``snr_db``: random messages,
    ``received = gain + N(0, sigma)`` with ``gain`` 1 (AWGN) or, with
    ``fade_block``, a Rayleigh magnitude ``sqrt((i^2 + q^2) / 2)`` constant
    over blocks of that many samples in row-major order."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (rows, code.k))
    words = (msgs @ code.g.astype(np.int64) % 2).astype(np.int32)
    noise = rng.normal(0.0, sigma_for_snr(snr_db, code.rate), words.shape)
    gain = 1.0
    if fade_block:
        nblocks = -(-words.size // fade_block)
        iq = rng.normal(0.0, 1.0, (2, nblocks))
        mag = np.sqrt((iq[0] ** 2 + iq[1] ** 2) / 2.0)
        gain = np.repeat(mag, fade_block)[:words.size].reshape(words.shape)
    received = gain + noise
    llr = np.where(words == 0, received, -received).astype(np.float32)
    return llr, words


def failures_first(port, llr, words, keep):
    """The first ``keep`` rows with the port's K1-twin detected failures
    first (stable), and how many of them are failures."""
    code = port["code"]
    soft = nms_edge.decode_final_edge(port["nms_params"], code.h,
                                      torch.as_tensor(llr), port["num_iterations"])
    failed = nms.frame_stats(soft, torch.as_tensor(words), code.h)[
        "detected_failure"].numpy()
    rows = np.argsort(~failed, kind="stable")[:keep]
    return llr[rows], words[rows], int(failed[rows].sum())


def load_case(run_dir, path_cut=None):
    """The port's run (CPU), JAX's artifacts and the (optionally cut) path's
    layout for one run directory."""
    run = RunDir(run_dir)
    port = convert.load_run(run_dir, "cpu")
    path = port["path"][:path_cut] if path_cut else port["path"]
    return layout(path, port["code"].k,
                  int(port["config"].get("num_segments", 6))) | {
        "port": port,
        "jax_nms": run.load_pickle("nms_params.pkl"),
        "jax_dia": run.load_pickle("dia_model_cnn.pkl"),
        "jax_fcn": jdia.stopper_engine_params(run.load_pickle("stopper_params.pkl")),
    }


def jax_phase2(case, llr, labels):
    """JAX's phase-2 step with its bit-exact XLA decoder: (outputs,
    refined, detected), and JAX's (T+1, B, n) trajectory of the rows."""
    port = case["port"]
    code, iters = port["code"], port["num_iterations"]
    cfg = port["config"]
    jstep = jengine.make_dl_osd_step_from_llr(
        jdia.make_dia("model_cnn", code.n, iters + 1), jax_get_code(code.name),
        port["variant"], iters, window=int(cfg.get("window", 5)),
        soft_margin=float(cfg.get("soft_margin", 0.9)), bounds=case["bounds"],
        decoder="xla")
    out = jstep(
        case["jax_nms"], case["jax_dia"], jnp.asarray(llr), jnp.asarray(labels),
        jnp.asarray(case["teps"]), jnp.asarray(case["mask"]),
        jnp.asarray(case["acc"], jnp.int32), case["jax_fcn"])
    jtraj = jnms.decode(case["jax_nms"], jnp.asarray(code.h, jnp.float32),
                        jnp.asarray(llr), iters, port["variant"])
    return out, np.array(jtraj)


def port_phase2(case, llr, labels):
    """The port's phase-2 step on the CPU: (outputs, refined, detected)."""
    port = case["port"]
    cfg = port["config"]
    step = engine.make_dl_osd_step_from_llr(
        port["dia"], port["code"], port["variant"], port["num_iterations"],
        case["layout"], window=int(cfg.get("window", 5)),
        soft_margin=float(cfg.get("soft_margin", 0.9)))
    with torch.no_grad():
        return step(port["nms_params"], torch.as_tensor(llr),
                    torch.as_tensor(labels), port["fcn"])


def refine(port, traj):
    """The port's DIA on a (T+1, B, n) trajectory."""
    with torch.no_grad():
        return port["dia"].refine_fast(
            torch.as_tensor(traj).permute(1, 0, 2)).numpy()


def assert_phase2_matches(case, llr, labels, step_tol):
    """Walk decisions and detected flags equal; the DIA on JAX's trajectory
    within ``RTOL``/``ATOL`` of JAX's refined values, the port's whole step
    within ``step_tol``.  Returns (detected count, max |refined - JAX|)."""
    (ref, ref_refined, ref_det), jtraj = jax_phase2(case, llr, labels)
    got, refined, det = port_phase2(case, llr, labels)
    for key in WALK_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)
    np.testing.assert_array_equal(det.numpy(), np.asarray(ref_det))
    ref_refined = np.asarray(ref_refined)
    np.testing.assert_allclose(refine(case["port"], jtraj), ref_refined,
                               rtol=RTOL, atol=ATOL)
    refined = refined.numpy()
    np.testing.assert_allclose(refined, ref_refined, rtol=step_tol, atol=step_tol)
    return int(det.sum()), float(np.abs(refined - ref_refined).max())
