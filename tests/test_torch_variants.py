"""The NMS variants of the port (NMS-2, NMS-3, ENMS, NMS-r) vs the JAX
package on the CPU, where every wrapper runs its kernel's plain twin.

* K4, K3 and K7 (their twins) at NMS-3 weights with ``bit1 != bit2``, so
  that ``w_vc != w_marg``, against goldens built from the numpy hash
  sampler and JAX's XLA decoder at the same parameters (JAX's K3/K4 draw
  from the TPU's on-core PRNG and cannot run here, ``torch_mc_common``);
  K8 against JAX's interpret-mode cascade kernels.  Counters exactly equal.
* The two identities the records show, through ``run_nms_mc``: NMS-2 and
  NMS-3 at their initial parameters have the same three weights, so the
  same counters; CCSDS's extended H is H, so ENMS is NMS-1 frame for frame
  through the same capture route.
* NMS-r's phase 2 (the trajectory form, ``engine.make_dl_osd_step``) on 48
  failure rows with the trained weights of ``runs/r5_variants_nmsr`` and
  the DIA and stopper of ``runs/r4_pipeline``: the port's dense decoder
  against JAX's within 1e-5 of the largest output, hard decisions and walk
  decisions identical; the DIA on JAX's trajectory within ``RTOL``/``ATOL``
  of JAX's refined values, the step's own within ``STEP_TOL`` (the
  phase-2 tolerance of ``tests/test_torch_multicode.py``).
* ``nms.decode`` runs NMS-r's network beside the frames whatever device
  the caller keeps the parameters on (the card's re-decode of fewer than
  ``NMS_R_MIN_BATCH`` rows failed on it).
* A tiny ``run_recipe`` with ``variant="NMS-r"`` end to end, its routes,
  and ``system.TwoPhase`` on the run directory it writes.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.ops import mc_cascade as jcascade
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.pipeline.recipe import RunDir as JaxRunDir
from short_ldpc_decoding_osd_tpu_torch import convert, system
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import mc_cascade, mc_dense, nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import engine
from short_ldpc_decoding_osd_tpu_torch.pipeline import recipe as rec
from torch_mc_common import _golden
from torch_phase2_common import ATOL, RTOL, WALK_KEYS, layout, seeded_rows
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(_ROOT, "runs", "r4_pipeline")
NMSR = os.path.join(_ROOT, "runs", "r5_variants_nmsr", "nms_params.pkl")
# trajectories of the port's dense decoder against JAX's, relative to the
# largest output: f32 sums of the same terms in another order
TRAJ_TOL = 1e-5
# the step's refined values, on the port's own trajectory, against JAX's
STEP_TOL = 1e-4


def _nms3_params():
    """NMS-3 parameters drawn with numpy, ``bit1 != bit2``: the port's
    tensors and JAX's tree of the same values."""
    vals = np.random.default_rng(15).uniform(-0.8, 0.8, 3).astype(np.float32)
    tree = {key: vals[i:i + 1] for i, key in enumerate(("check", "bit1", "bit2"))}
    port = {k: torch.as_tensor(v) for k, v in tree.items()}
    w_vc, _, w_marg = nms.scalar_weights(port, "NMS-3")
    assert abs(w_vc - w_marg) > 0.1
    return port, {k: jnp.asarray(v) for k, v in tree.items()}


# --- K4, K3, K7 and K8 at NMS-3 weights --------------------------------------

@pytest.mark.parametrize("kernel", ["K4", "K3", "K7"])
def test_mc_counters_at_nms3_weights_match_jax_golden(kernel):
    code = get_code("ccsds_128_64")
    port, tree = _nms3_params()
    seed, batch, iters, block = 23, 1024, 8, 512
    if kernel == "K4":
        got = nms_edge.fused_counters_edge(code, port, "NMS-3", iters, 2.5, batch,
                                           seed, device="cpu")
        stages = ()
    elif kernel == "K7":
        got = mc_dense.fused_counters(code, port, "NMS-3", iters, 2.5, batch, seed,
                                      device="cpu")
        stages = ()
    else:
        got = nms_edge.fused_counters_edge_compact(
            code, port, "NMS-3", iters, 2.5, batch, seed, block_frames=block,
            schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device="cpu")
        rows, _ = nms_edge.build_rows_schedule(nms_edge.DEFAULT_COMPACT_SCHEDULE,
                                               block, iters)
        stages = rows
    want, overflow = _golden("ccsds_128_64", seed, batch, iters, snr_db=2.5,
                             stages=stages, block=block, params=tree,
                             variant="NMS-3")
    assert int(got[0]) == batch and want[1] > 0
    if kernel == "K3":
        assert int(got[5]) == overflow
    np.testing.assert_array_equal(got[:5].numpy(), want)


def test_cascade_at_nms3_weights_matches_jax_pallas():
    port, tree = _nms3_params()
    kw = dict(t1=4, block_frames=256)
    ref = np.asarray(jcascade.cascade_counters(
        jax_get_code("ccsds_128_64"), tree, "NMS-3", 8, 2.5, 1024, 29,
        mode="highest", interpret=True, **kw))
    got = mc_cascade.cascade_counters(get_code("ccsds_128_64"), port, "NMS-3", 8,
                                      2.5, 1024, 29, device="cpu", **kw)
    assert int(got[0]) == 1024
    np.testing.assert_array_equal(got.numpy(), ref)


# --- the records' identities through run_nms_mc -------------------------------

def test_nms2_and_nms3_at_init_give_the_same_counters():
    code = get_code("ccsds_128_64")
    p2, p3 = nms.init_params("NMS-2"), nms.init_params("NMS-3")
    assert nms.scalar_weights(p2, "NMS-2") == nms.scalar_weights(p3, "NMS-3")
    kw = dict(batch=1024, error_budget=10**6, max_frames=1024, seed=5,
              device="cpu")
    s2, _ = harness.run_nms_mc(code, p2, "NMS-2", 12, 3.0, **kw)
    s3, _ = harness.run_nms_mc(code, p3, "NMS-3", 12, 3.0, **kw)
    assert s2 == s3 and s2.frames == 1024 and s2.frame_errors > 0
    # and on K7's twin (another rung, the same hash frames)
    kw |= {"rung": "dense"}
    d2, _ = harness.run_nms_mc(code, p2, "NMS-2", 12, 3.0, **kw)
    d3, _ = harness.run_nms_mc(code, p3, "NMS-3", 12, 3.0, **kw)
    assert d2 == d3 and d2.frames == 1024


def test_ccsds_enms_is_nms1_frame_for_frame():
    """ENMS decodes on ``extended().h``, which for CCSDS is H itself, so on
    the capture route (K1's twin here) it captures the same failures as
    NMS-1 with the same counters, and on the fused branch (K3's twin, hash
    frames) it counts as NMS-1 does."""
    code = get_code("ccsds_128_64")
    assert np.array_equal(code.extended().h, code.h)
    params = nms.init_params("NMS-1")
    kw = dict(batch=512, error_budget=10**6, max_frames=1024, seed=7,
              capture_failures=True, capture_trajectories=False, device="cpu")
    got = harness.run_nms_mc(code, params, "ENMS", 12, 3.0, **kw)
    want = harness.run_nms_mc(code, params, "NMS-1", 12, 3.0, **kw)
    assert got[0] == want[0] and got[0].frame_errors > 0
    np.testing.assert_array_equal(got[1].trajectories, want[1].trajectories)
    np.testing.assert_array_equal(got[1].labels, want[1].labels)
    # and the route without capture is the fused branch, NMS-1's too
    fused = {v: harness.run_nms_mc(code, params, v, 12, 3.0,
                                   **kw | {"capture_failures": False})[0]
             for v in ("ENMS", "NMS-1")}
    assert fused["ENMS"] == fused["NMS-1"] and fused["ENMS"].frames == 1024


# --- NMS-r's phase 2 against JAX ----------------------------------------------

@pytest.fixture(scope="module")
def nms_r_case():
    """48 NMS-r failure rows at 2.5 dB (the trained weights' failures first)
    and the r4_pipeline DIA, stopper and path on both sides."""
    code = get_code("ccsds_128_64")
    tree = convert.load_jax_pickle(NMSR)
    params = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in tree.items()}
    llr, words = seeded_rows(code, 2.5, 1024, 41)
    soft = nms.decode_final(params, code.h, torch.as_tensor(llr), 12, "NMS-r",
                            nms.edge_columns(code.h))
    failed = nms.frame_stats(soft, torch.as_tensor(words), code.h)[
        "detected_failure"].numpy()
    rows = np.argsort(~failed, kind="stable")[:48]
    assert failed[rows].all()
    run = convert.load_run(R4, "cpu")
    jrun = JaxRunDir(R4)
    return layout(run["path"], code.k) | {
            "code": code, "params": params, "tree": tree, "llr": llr[rows],
            "labels": words[rows], "run": run,
            "jax_dia": jrun.load_pickle("dia_model_cnn.pkl"),
            "jax_fcn": jdia.stopper_engine_params(jrun.load_pickle(
                "stopper_params.pkl"))}


def test_nms_r_phase2_matches_jax(nms_r_case):
    case = nms_r_case
    code, run = case["code"], case["run"]
    llr, labels = case["llr"], case["labels"]
    route = engine.redecode_route(code.h, "NMS-r", torch.device("cpu"), len(llr))
    assert route == "dense"
    traj = engine.redecode_trajectory(case["params"], code.h, torch.as_tensor(llr),
                                      12, "NMS-r", route)
    jtraj = np.array(jnms.decode(case["tree"], jnp.asarray(code.h, jnp.float32),
                                   jnp.asarray(llr), 12, "NMS-r",
                                   jnp.asarray(jnms.edge_columns(code.h))))
    got = traj.numpy()
    assert got.shape == jtraj.shape == (13, 48, code.n)
    assert np.abs(got - jtraj).max() <= TRAJ_TOL * max(np.abs(jtraj).max(), 1.0)
    np.testing.assert_array_equal(got < 0, jtraj < 0)

    step = engine.make_dl_osd_step(run["dia"], code.h_osd, code.k,
                                   case["layout"])
    with torch.no_grad():
        out, refined = step(traj.permute(1, 0, 2), torch.as_tensor(labels),
                            run["fcn"])
    jstep = jengine.make_dl_osd_step(jdia.make_dia("model_cnn", code.n, 13),
                                     jnp.asarray(jax_get_code(code.name).h_osd),
                                     code.k, bounds=case["bounds"])
    ref, ref_refined = jstep(case["jax_dia"], jnp.asarray(jtraj).transpose(1, 0, 2),
                             jnp.asarray(labels), jnp.asarray(case["teps"]),
                             jnp.asarray(case["mask"]),
                             jnp.asarray(case["acc"], jnp.int32), case["jax_fcn"])
    for key in WALK_KEYS + ("deep_limit", "windows_evaluated"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), key)
    with torch.no_grad():
        dia_on_jax = run["dia"].refine_fast(
            torch.as_tensor(jtraj).permute(1, 0, 2)).numpy()
    np.testing.assert_allclose(dia_on_jax, np.asarray(ref_refined), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(refined.numpy(), np.asarray(ref_refined),
                               rtol=STEP_TOL, atol=STEP_TOL)


def test_dense_decoder_runs_beside_the_frames(monkeypatch):
    """``nms.decode`` moves the parameters to the frames' device: callers
    (``system.TwoPhase``, the capture step) keep them on the host for the
    kernel wrappers, and NMS-r's network must run on the card beside a
    re-decode of fewer than ``NMS_R_MIN_BATCH`` rows.  Shapes only: the
    frames lie on the meta device, the parameters on the CPU."""
    code = get_code("ccsds_128_64")
    seen = []
    real = nms._check_update_neural

    def spy(vc, h, params, edge_cols):
        seen.append({k: v.device.type for k, v in params.items()} | {
            "vc": vc.device.type})
        return real(vc, h, params, edge_cols)
    monkeypatch.setattr(nms, "_check_update_neural", spy)
    params = nms.init_params("NMS-r", code.h)
    llr = torch.zeros((4, code.n), device="meta")
    out = nms.decode(params, code.h, llr, 2, "NMS-r", nms.edge_columns(code.h))
    assert out.shape == (3, 4, code.n) and out.device.type == "meta"
    assert seen and all(set(d.values()) == {"meta"} for d in seen)
    assert params["nn_w1"].device.type == "cpu"  # the caller's stay put


# --- a tiny NMS-r recipe -----------------------------------------------------

def test_run_recipe_nms_r_routes(tmp_path, monkeypatch):
    """``run_recipe(variant="NMS-r")`` on the CPU at a tiny size, stage 1
    reused from the trained weights of ``runs/r5_variants_nmsr`` (an
    untrained NMS-r fails every frame, which leaves the stopper no
    samples): every capture re-decodes trajectories (the harvest and each
    eval point), phase 2 is the trajectory step, and no fused counter
    kernel and no raw-LLR step is called."""
    calls = []

    def record(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((nms_edge, "fused_counters_edge"),
                         (nms_edge, "fused_counters_edge_compact"),
                         (mc_dense, "fused_counters"),
                         (engine, "make_dl_osd_step"),
                         (engine, "make_dl_osd_step_from_llr"),
                         (harness, "trajectories_for_llrs")):
        record(module, name)
    decoders = []
    real_build = harness.build_nms_mc_step

    def build(*a, **k):
        built = real_build(*a, **k)
        decoders.append(built.decoder)
        return built
    monkeypatch.setattr(harness, "build_nms_mc_step", build)
    real_dia, real_stop = rec.train_dia, rec.train_stopper
    monkeypatch.setattr(rec, "train_dia", lambda code, t, l, cfg, **kw: real_dia(
        code, t, l, dataclasses.replace(cfg, termination_step=40, batch=16), **kw))
    monkeypatch.setattr(rec, "train_stopper", lambda i, l, cfg, **kw: real_stop(
        i, l, dataclasses.replace(cfg, termination_step=40, batch=64), **kw))
    cfg = rec.RecipeConfig(variant="NMS-r", num_iterations=6, nms_error_budget=40,
                           osd_failure_budget=24, train_failure_target=48,
                           max_frames_per_snr=2048, eval_batch=512,
                           capture_batch=512, decoding_length=8)
    shutil.copy(NMSR, tmp_path / "nms_params.pkl")
    curve = rec.run_recipe(cfg, str(tmp_path), snrs=[2.5, 3.0],
                           log=lambda *_: None, device="cpu")
    assert len(curve["points"]) == 2
    for point in curve["points"]:
        assert point["osd"]["success"] + point["osd"]["fail"] > 0
        assert point["osd_unconfirmed"] == 0
        assert len(point["ce_list"]) == cfg.num_iterations + 2
    # harvest + one capture a point, each re-decoded into trajectories on
    # the dense decoder; the trajectory step built once
    assert decoders == ["plain"] * 3
    assert calls.count("trajectories_for_llrs") == 3
    assert calls.count("make_dl_osd_step") == 1
    assert not {"fused_counters_edge", "fused_counters_edge_compact",
                "fused_counters", "make_dl_osd_step_from_llr"} & set(calls)
    run = rec.RunDir(str(tmp_path))
    traj = np.load(run.path("train_failures.npz"))["traj"]
    assert traj.shape[1:] == (cfg.num_iterations + 1, 128)
    assert not run.has("nms_train_summary.json")
    assert convert.load_run(str(tmp_path), "cpu")["variant"] == "NMS-r"
    # the two-phase system on the written run directory
    tp = system.TwoPhase(str(tmp_path), cap_b=512, cap=64, device="cpu")
    assert tp.capture_step.decoder == "plain"
    out = tp.measure(1)
    assert out["system_frames"] == 512 and out["system_osd_rows_walked"] == 64
    assert 0 < out["system_failures"] <= 512
    assert out["system_osd_success"] <= min(out["system_failures"], 64)
