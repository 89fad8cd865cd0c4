"""The end-to-end two-phase recipe in one run directory.

Port of ``short_ldpc_decoding_osd_tpu/pipeline/recipe.py``, which replaces
the reference's 7 stage directories and their filesystem hand-off
('Training and Testing recipe.txt:7-18'):

1+2. train the NMS decoder at the training SNR (frames made on the device),
3.   harvest NMS failures at the training SNR, train the DIA refiner, build
     the ratio-normalized order-pattern decoding path, generate stopper
     samples and train the sliding-window stopper,
4+5. per-SNR Monte-Carlo NMS evaluation with failure capture (error-budget
     early stop),
6.   DIA-OSD evaluation of the captured failures per SNR,
7.   FER_total(SNR) = FER_NMS(SNR) * FER_OSD(SNR).

Each stage reuses its artifact when the run directory has it.  The
parameter pickles (``nms_params.pkl``, ``dia_<model>.pkl``,
``stopper_params.pkl``) hold plain numpy trees in the JAX package's key
layout (``convert.to_jax_params``), so either package reads the other's
run directory; the JSON artifacts have JAX's names and fields.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time

import numpy as np
import torch

from .. import convert
from .._device import resolve_device
from ..codes import Code, get_code
from ..mc import harness
from ..models import canonical_dia_name, stopper_engine_params
from ..osd import engine, segments
from ..train import (
    DIATrainConfig,
    NMSTrainConfig,
    StopperTrainConfig,
    generate_stopper_samples,
    pattern_statistics_sweep,
    reform_windows,
    train_dia,
    train_nms,
    train_stopper,
)
from ..utils.metrics import wilson_interval
from ..utils.profiling import JsonlLogger, Timer

# phase-2 rows a call in the eval sweep (JAX walks fixed 4096-row chunks)
OSD_CHUNK = 4096
# the capture step's largest batch: 262,144 CCSDS frames take ~1.5 ms in
# K1 on an H100 (PERF.md), far above the host's per-step cost, and a
# larger step only coarsens the error budget's early stop
CAPTURE_MAX_FRAMES = 262_144
# share of the card's free memory one capture step may take
CAPTURE_MEMORY_SHARE = 0.5


@dataclasses.dataclass
class RecipeConfig:
    code_name: str = "ccsds_128_64"
    variant: str = "NMS-1"
    num_iterations: int = 12
    training_snr: float = 2.7
    dia_model: str = "model_cnn"
    threshold_sum: int = 3
    decoding_length: int = 30
    window: int = 5
    soft_margin: float = 0.9
    num_segments: int = 6
    # budgets
    nms_error_budget: int = 40_000
    osd_failure_budget: int = 500
    train_failure_target: int = 20_000
    max_frames_per_snr: int = 10**8
    # optional per-SNR-point scaling of max_frames, low -> high SNR
    # (reference portion_dis, ``Testing_data_gen_128/Main_test.py:90-106``)
    frame_portions: tuple = ()
    eval_batch: int = 4096
    # capture-sweep batch; None = sized by capture_batch()
    capture_batch: int | None = None
    seed: int = 0


def capture_frame_bytes(decode_h, variant: str, route: str) -> int:
    """Bytes one frame of the capture step holds on the card at its peak,
    on ``route`` (one of ``harness.DECODERS``); f32 and int32 take 4 B,
    int64 8 B, bool 1 B.

    * Every route: ``sample_batch``'s noise, received values, codeword
      product, int32 codewords and LLRs (5 x 4n) and its int64 messages
      (8k <= 8n); the decoder's (B, n) output (4n); ``frame_stats``' hard
      decisions, error flags and f32 syndrome (4n + n + 2 x 4m); the
      capture's sort key and int64 index (1 + 8): 33n + 8m + 9.
    * ``edge`` (K1) and ``dense`` (K6) keep their messages on chip: nothing
      more.
    * ``edge_padded``: the (B, dc, m) messages and ~8 live temporaries of
      their size a min-sum update: 9 x 4 dc m.
    * ``plain``: the same over the dense (B, m, n) message tensor:
      9 x 4 m n.
    * NMS-r adds its leave-one-out rows (B, m, dc, dc-1): gathered, sorted
      values and int64 indices, the first layer's output: 20 m dc (dc-1).
    """
    h = np.asarray(decode_h)
    m, n = h.shape
    dc = int(h.sum(axis=1).max())
    total = 33 * n + 8 * m + 9
    if route == "edge_padded":
        total += 9 * 4 * dc * m
    elif route == "plain":
        total += 9 * 4 * m * n
    if variant == "NMS-r" and route in ("edge_padded", "plain"):
        total += 20 * m * dc * (dc - 1)
    return total


def capture_batch(cfg: RecipeConfig, code: Code,
                  device: str | torch.device = "cuda") -> int:
    """Frames a step of the capture sweeps (harvest, eval sweep).

    ``cfg.capture_batch`` when set; ``cfg.eval_batch`` on the CPU; on the
    card the most frames, in steps of 256 and up to
    :data:`CAPTURE_MAX_FRAMES`, whose :func:`capture_frame_bytes` on the
    route ``harness.select_decoder`` picks fit in
    :data:`CAPTURE_MEMORY_SHARE` of ``torch.cuda.mem_get_info``'s free
    bytes.  Where its edge kernel does not hold the code, NMS-r's route
    depends on the batch, so a batch that changes it is sized again on the
    new route.  (JAX sizes this from a TPU HBM model,
    ``recipe.py:76-115``; the port does not copy it.)"""
    if cfg.capture_batch is not None:
        return cfg.capture_batch
    dev = torch.device(device)
    if dev.type != "cuda":
        return cfg.eval_batch
    decode_h = np.asarray(code.extended().h if cfg.variant == "ENMS" else code.h)
    free, _ = torch.cuda.mem_get_info(dev)

    def fit(batch):
        route = harness.select_decoder(decode_h, cfg.variant, batch, device=dev)
        frames = int(free * CAPTURE_MEMORY_SHARE) // capture_frame_bytes(
            decode_h, cfg.variant, route)
        return route, max(256, min(CAPTURE_MAX_FRAMES, frames // 256 * 256))

    route, batch = fit(CAPTURE_MAX_FRAMES)
    route_b, batch_b = fit(batch)
    return batch if route_b == route else batch_b


class RunDir:
    """Tiny artifact store for one pipeline run.  Pickles load through
    ``convert.load_jax_pickle``, so a JAX-written directory reads alike."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def save_json(self, name: str, obj):
        with open(self.path(name), "wt") as fh:
            json.dump(obj, fh, indent=1, default=str)

    def load_json(self, name: str):
        with open(self.path(name), "rt") as fh:
            return json.load(fh)

    def save_pickle(self, name: str, obj):
        with open(self.path(name), "wb") as fh:
            pickle.dump(obj, fh)

    def load_pickle(self, name: str):
        return convert.load_jax_pickle(self.path(name))

    def has(self, name: str) -> bool:
        return os.path.exists(self.path(name))


def host_params(tree: dict) -> dict:
    """An NMS parameter tree -> float32 CPU tensors (the kernel wrappers
    read the scalar weights on the host)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in tree.items()}


def stage_train_nms(cfg: RecipeConfig, run: RunDir, log=print,
                    device: str | torch.device = "cuda") -> dict:
    """Stages 1+2: the NMS parameters as CPU tensors (:func:`host_params`)."""
    if run.has("nms_params.pkl"):
        return host_params(run.load_pickle("nms_params.pkl"))
    code = get_code(cfg.code_name)
    t0 = time.time()
    params, summary = train_nms(
        code,
        NMSTrainConfig(variant=cfg.variant, num_iterations=cfg.num_iterations,
                       snr_lo=cfg.training_snr, snr_hi=cfg.training_snr,
                       seed=cfg.seed),
        ckpt_dir=run.path("ckpt_nms"),
        log_fn=lambda r: log(f"  nms step {r['step']} loss {r['loss']:.1f} "
                             f"fer {r['fer']:.3f}"),
        device=device)
    tree = convert.nms_to_jax(params)
    run.save_pickle("nms_params.pkl", tree)
    run.save_json("nms_train_summary.json",
                  summary | {"elapsed_s": time.time() - t0})
    return host_params(tree)


def stage_harvest_failures(cfg: RecipeConfig, run: RunDir, nms_params, log=print,
                           device: str | torch.device = "cuda"):
    """Stage 3a: NMS failures at the training SNR, captured by the capture
    step (K1 on the card) and re-decoded into trajectories by the dense
    decoder, as in JAX."""
    if run.has("train_failures.npz"):
        blob = np.load(run.path("train_failures.npz"))
        return harness.FailureBatch(blob["traj"], blob["labels"],
                                    int(blob["overflow"]))
    code = get_code(cfg.code_name)
    stats, fb = harness.run_nms_mc(
        code, nms_params, cfg.variant, cfg.num_iterations, cfg.training_snr,
        batch=capture_batch(cfg, code, device),
        error_budget=cfg.train_failure_target,
        max_frames=cfg.max_frames_per_snr, seed=cfg.seed + 1,
        capture_failures=True, capture_limit=cfg.train_failure_target,
        device=device)
    log(f"  harvested {len(fb.trajectories)} failures from {stats.frames} "
        f"frames (FER {stats.fer:.3e})")
    # uncompressed: regenerable scratch, and gzip costs more than it saves
    np.savez(run.path("train_failures.npz"), traj=fb.trajectories,
             labels=fb.labels, overflow=fb.overflow)
    run.save_json("train_failures_meta.json", stats.to_dict())
    return fb


def stage_train_dia_and_path(cfg: RecipeConfig, run: RunDir, fb, log=print,
                             device: str | torch.device = "cuda"):
    """Stage 3b: the trained DIA (a module on ``device``) and the decoding
    path; reused from the run directory when it holds both for this
    operating point."""
    dev = resolve_device(device)
    code = get_code(cfg.code_name)
    name = canonical_dia_name(cfg.dia_model)
    model_tag = f"dia_{name}"
    op_point = {"threshold_sum": cfg.threshold_sum,
                "decoding_length": cfg.decoding_length,
                "num_segments": cfg.num_segments}
    if run.has(model_tag + ".pkl") and run.has("decoding_path.json"):
        blob = run.load_json("decoding_path.json")
        # a path built for another (or an unrecorded) operating point would
        # evaluate the wrong decoder: regenerate it
        if blob.get("operating_point") == op_point:
            state = convert.dia_state_from_jax(run.load_pickle(model_tag + ".pkl"),
                                               dev)
            model = convert.dia_module(name, code.n, cfg.num_iterations + 1,
                                       state)
            return model, blob["path"]
        log("  cached decoding path has a different operating point; "
            "regenerating")
    t0 = time.time()
    model, history = train_dia(
        code, fb.trajectories, fb.labels,
        DIATrainConfig(model=name, seed=cfg.seed),
        # per-model checkpoints: a shared directory would restore one
        # refiner's weights into another when a run trains both
        ckpt_dir=run.path(f"ckpt_{model_tag}"),
        log_fn=lambda r: log(f"  dia step {r['step']} loss {r['loss']:.1f}"),
        device=dev)
    run.save_json(model_tag + "_train_summary.json",
                  {"history": history, "elapsed_s": time.time() - t0})
    sweep = pattern_statistics_sweep(code, model, fb.trajectories, fb.labels,
                                     num_segments=cfg.num_segments, device=dev)
    counter = sweep["pattern_counter"]
    counter.save(run.path("pattern_counts.json"))
    decoding_path = counter.decoding_path(cfg.threshold_sum, cfg.decoding_length)
    if [0] * cfg.num_segments not in decoding_path:
        decoding_path = ([[0] * cfg.num_segments]
                         + decoding_path[:cfg.decoding_length - 1])
    run.save_json("decoding_path.json", {
        "path": decoding_path,
        "operating_point": op_point,
        "hist_initial": dict(sweep["hist_initial"]),
        "hist_final": dict(sweep["hist_final"]),
        "hist_refined": dict(sweep["hist_refined"]),
    })
    run.save_pickle(model_tag + ".pkl", convert.dia_to_jax(model))
    log(f"  decoding path ({len(decoding_path)} patterns): "
        f"{decoding_path[:6]}...")
    return model, decoding_path


def stage_train_stopper(cfg: RecipeConfig, run: RunDir, model, fb,
                        decoding_path, log=print,
                        device: str | torch.device = "cuda") -> dict:
    """Stage 3c: the stopper's engine weights ``{w1, w2}`` on ``device``."""
    dev = resolve_device(device)
    if run.has("stopper_params.pkl"):
        return convert.stopper_from_jax(run.load_pickle("stopper_params.pkl"),
                                        dev)
    code = get_code(cfg.code_name)
    records, summary = generate_stopper_samples(
        code, model, fb.trajectories, fb.labels, decoding_path,
        num_segments=cfg.num_segments, device=dev)
    run.save_json("stopper_samples_summary.json", summary)
    ins, labs = reform_windows(records, cfg.window)
    stopper, val = train_stopper(
        ins, labs, StopperTrainConfig(window=cfg.window, seed=cfg.seed),
        device=dev)
    run.save_json("stopper_validation.json", val)
    fcn = stopper_engine_params(stopper)
    run.save_pickle("stopper_params.pkl", convert.stopper_to_jax(fcn))
    log(f"  stopper validation: {val}")
    return fcn


def _walk_llr_rows(osd_step_llr, nms_params, fb, n_osd, fcn, dev):
    """The fused phase 2 over the first ``n_osd`` raw rows, OSD_CHUNK rows a
    call: per-row columns, host numpy."""
    cols = {key: [] for key in ("succ", "strict", "cplx", "win", "det", "ce",
                                "ber")}
    for i0 in range(0, n_osd, OSD_CHUNK):
        hi = min(i0 + OSD_CHUNK, n_osd)
        out, _, det, (ce_rows, ber_rows) = osd_step_llr(
            nms_params,
            torch.as_tensor(fb.trajectories[i0:hi, 0], device=dev),
            torch.as_tensor(fb.labels[i0:hi], device=dev), fcn)
        for key, val in (("succ", out["success"]),
                         ("strict", out["strict_success"]),
                         ("cplx", out["complexity"]), ("win", out["window_num"]),
                         ("det", det), ("ce", ce_rows), ("ber", ber_rows)):
            cols[key].append(val.cpu().numpy())
    return {key: np.concatenate(val) for key, val in cols.items()}


def _walk_trajectories(osd_step, fb, n_osd, fcn, dev):
    """The trajectory-form phase 2 over the first ``n_osd`` captured
    trajectories, OSD_CHUNK rows a call: per-row columns, host numpy."""
    cols = {key: [] for key in ("succ", "strict", "cplx", "win", "refined")}
    for i0 in range(0, n_osd, OSD_CHUNK):
        hi = min(i0 + OSD_CHUNK, n_osd)
        out, refined = osd_step(
            torch.as_tensor(fb.trajectories[i0:hi], device=dev),
            torch.as_tensor(fb.labels[i0:hi], device=dev), fcn)
        for key, val in (("succ", out["success"]),
                         ("strict", out["strict_success"]),
                         ("cplx", out["complexity"]), ("win", out["window_num"]),
                         ("refined", refined)):
            cols[key].append(val.cpu().numpy())
    return {key: np.concatenate(val) for key, val in cols.items()}


def stage_eval_sweep(cfg: RecipeConfig, run: RunDir, nms_params, model, fcn,
                     decoding_path, snrs, log=print,
                     device: str | torch.device = "cuda") -> dict:
    """Stages 4-7: per-SNR NMS evaluation + DIA-OSD on its failures ->
    the total FER, with Wilson intervals on both stages and a delta-method
    interval on their product; each point goes to ``metrics.jsonl`` and
    the curve to ``fer_curve.json``.

    Phase 2 follows JAX's choice: on the card (every variant but NMS-r) the
    capture hands over raw LLR rows and the from-LLR step re-decodes them
    (K2), refines, prepares (GE) and walks (K5), with per-row CE/BER;
    rows the re-decode does not confirm as detected failures are excluded.
    Otherwise the capture re-decodes trajectories on the host's dense
    decoder and the trajectory step walks them, the CE/BER lists summed in
    f64 on the host."""
    dev = resolve_device(device)
    code = get_code(cfg.code_name)
    layout = segments.TepLayout.build(decoding_path, code.k, cfg.num_segments,
                                      dev)
    fused_phase2 = dev.type == "cuda" and cfg.variant != "NMS-r"
    walk = dict(window=cfg.window, soft_margin=cfg.soft_margin)
    if fused_phase2:
        osd_step_llr = engine.make_dl_osd_step_from_llr(
            model, code, cfg.variant, cfg.num_iterations, layout,
            with_iteration_stats=True, **walk)
    else:
        osd_step = engine.make_dl_osd_step(model, code.h_osd, code.k, layout,
                                           **walk)
    jsonl = JsonlLogger(run.path("metrics.jsonl"))
    curve = []
    for idx, snr in enumerate(snrs):
        portion = (cfg.frame_portions[min(idx, len(cfg.frame_portions) - 1)]
                   if cfg.frame_portions else 1.0)
        t0 = time.time()
        cap_batch = capture_batch(cfg, code, dev)
        stats, fb = harness.run_nms_mc(
            code, nms_params, cfg.variant, cfg.num_iterations, float(snr),
            batch=cap_batch, error_budget=cfg.nms_error_budget,
            max_frames=max(int(cfg.max_frames_per_snr * portion), cap_batch),
            seed=cfg.seed + int(snr * 100), capture_failures=True,
            # 25% headroom over the walk budget for unconfirmed rows
            capture_limit=max(int(cfg.osd_failure_budget * 1.25), 2000),
            capture_trajectories=not fused_phase2, device=dev)
        nms_time = time.time() - t0
        t1 = time.time()
        n_osd = min(len(fb.trajectories), cfg.osd_failure_budget)
        osd_stats = {"success": 0, "fail": 0, "complexity": 0, "windows": 0}
        ce_list, ber_list = [], []
        unconfirmed = 0
        if n_osd and fused_phase2:
            cols = _walk_llr_rows(osd_step_llr, nms_params, fb, n_osd, fcn,
                                  dev)
            valid = cols["det"]
            unconfirmed = int((~valid).sum())
            succ = cols["succ"][valid]
            nv = max(int(valid.sum()), 1)
            osd_stats = {
                "success": int(succ.sum()),
                "fail": int((~succ).sum()),
                "strict_success": int(cols["strict"][valid].sum()),
                "complexity": float(cols["cplx"][valid].mean())
                if valid.any() else 0.0,
                "windows": float(cols["win"][valid].mean())
                if valid.any() else 0.0,
            }
            ce_list = [float(x) for x in cols["ce"][valid].sum(axis=0)]
            ber_list = [float(x) / (nv * code.n)
                        for x in cols["ber"][valid].sum(axis=0)]
        elif n_osd:
            cols = _walk_trajectories(osd_step, fb, n_osd, fcn, dev)
            succ = cols["succ"]
            osd_stats = {
                "success": int(succ.sum()),
                "fail": int((~succ).sum()),
                "strict_success": int(cols["strict"].sum()),
                "complexity": float(cols["cplx"].mean()),
                "windows": float(cols["win"].mean()),
            }
            traj, labels = fb.trajectories[:n_osd], fb.labels[:n_osd]
            refined = cols["refined"]
            ce_list = harness.iteration_ce_list(traj, labels)
            ber_list = harness.iteration_ber_list(traj, labels)
            logits = -refined.astype(np.float64)
            z = labels.astype(np.float64)
            ce_list.append(float((np.maximum(logits, 0) - logits * z
                                  + np.log1p(np.exp(-np.abs(logits)))).sum()))
            ber_list.append(float(((refined <= 0) != (labels > 0)).mean()))
        osd_time = time.time() - t1
        fer_nms = stats.detected_failures / max(stats.frames, 1)
        denom = osd_stats["success"] + osd_stats["fail"]
        fer_osd = osd_stats["fail"] / denom if denom else 0.0
        fer_total = fer_nms * fer_osd + stats.ufer  # undetected errors are final
        lo, hi = stats.fer_confidence()
        # Wilson interval on the OSD stage; delta method on the product of
        # the two independent binomial stages:
        # var(log f_total) ~= var(log f_nms) + var(log f_osd)
        osd_lo, osd_hi = wilson_interval(osd_stats["fail"], max(denom, 1))
        if fer_nms > 0 and fer_osd > 0 and denom:
            se_nms = np.sqrt(fer_nms * (1 - fer_nms) / max(stats.frames, 1)) / fer_nms
            se_osd = np.sqrt(fer_osd * (1 - fer_osd) / denom) / fer_osd
            se_log = float(np.sqrt(se_nms ** 2 + se_osd ** 2))
            tot_ci = [fer_nms * fer_osd * np.exp(-1.96 * se_log) + stats.ufer,
                      fer_nms * fer_osd * np.exp(1.96 * se_log) + stats.ufer]
        else:
            tot_ci = [stats.ufer, hi * osd_hi + stats.ufer]
        point = {
            "snr_db": float(snr),
            "frames": stats.frames,
            "fer_nms_detected": fer_nms,
            "fer_nms_any": stats.fer,
            "fer_nms_ci": [lo, hi],
            "ufer": stats.ufer,
            "osd": osd_stats,
            "fer_osd": fer_osd,
            "fer_osd_ci": [osd_lo, osd_hi],
            "fer_total": fer_total,
            "fer_total_ci": [float(tot_ci[0]), float(tot_ci[1])],
            # rows the from-LLR re-decode did not confirm as detected
            # failures (fused phase 2 only; excluded from every OSD stat)
            "osd_unconfirmed": unconfirmed,
            "nms_time_s": nms_time,
            "osd_time_s": osd_time,
            "nms_frames_per_s": stats.frames / max(nms_time, 1e-9),
            "ce_list": ce_list,
            "ber_list": ber_list,
        }
        curve.append(point)
        jsonl.log(point)
        log(f"  snr {snr:.2f}: FER_nms {fer_nms:.3e} x FER_osd {fer_osd:.3e} "
            f"-> {fer_total:.3e} ({stats.frames} frames, {n_osd} OSD)")
        run.save_json("fer_curve.json", {"points": curve})
    return {"points": curve}


def run_recipe(cfg: RecipeConfig, run_root: str, snrs=None, log=print,
               device: str | torch.device = "cuda") -> dict:
    """All stages in ``run_root`` on ``device`` (the card unless the caller
    passes ``"cpu"``); returns the FER curve.  Each stage's seconds, closed
    by a device synchronisation, go to ``stage_seconds.json`` (a reused
    stage takes only its load)."""
    dev = resolve_device(device)
    run = RunDir(run_root)
    run.save_json("config.json", dataclasses.asdict(cfg))
    snrs = snrs if snrs is not None else np.linspace(2.0, 3.0, 6)
    timer = Timer(dev)
    log("[1/5] training NMS decoder")
    with timer.measure("train_nms"):
        nms_params = stage_train_nms(cfg, run, log, dev)
    log("[2/5] harvesting training failures")
    with timer.measure("harvest_failures"):
        fb = stage_harvest_failures(cfg, run, nms_params, log, dev)
    log("[3/5] training DIA + decoding path")
    with timer.measure("train_dia_and_path"):
        model, decoding_path = stage_train_dia_and_path(cfg, run, fb, log, dev)
    log("[4/5] training stopper")
    with timer.measure("train_stopper"):
        fcn = stage_train_stopper(cfg, run, model, fb, decoding_path, log, dev)
    log("[5/5] FER sweep")
    with timer.measure("eval_sweep"):
        curve = stage_eval_sweep(cfg, run, nms_params, model, fcn, decoding_path,
                                 snrs, log, dev)
    run.save_json("stage_seconds.json", timer.summary())
    return curve
