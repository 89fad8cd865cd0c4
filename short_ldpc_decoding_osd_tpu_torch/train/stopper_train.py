"""Sliding-window stopper: training samples and training (stage 3, phase 2).

Port of ``short_ldpc_decoding_osd_tpu/train/stopper_train.py`` (reference
``DL_Training_serial/interval_boundary.py`` + ``predict_phase.py``):

1. samples: for every NMS failure, DIA-refine, run ``engine.prepare`` (the
   GE kernel on the card) and the block minima of the whole decoding path
   (``engine.block_discrepancy_minima``, kernel K5 on the card), and
   locate the truth: success, failure, or an undetected frame, which is
   dropped and counted (``query_teps_dis``, ``interval_boundary.py:267-334``);
2. windows: width-5 windows over the block minima, label 1 iff the window
   holds the global minimum AND the frame is decodable (``reform_inputs``,
   ``interval_boundary.py:224-249``);
3. training: class-weighted softmax CE with a x10 penalty on a premature
   stop and L2 0.01 on ``dense1`` (``predict_phase.py:104-234``), Adam 1e-3,
   staircase 0.95/500, clip 5e2, the dataset resident on the device.

JAX guards the fused minima with a permanent demotion to its chunk scan
(``stopper_train.py:80-97``); the port does not: on a CUDA tensor the
kernels launch or raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import full_f32, resolve_device
from ..codes import Code
from ..models import dia as dia_mod
from ..osd import engine, segments
from .optim import StaircaseAdam


@dataclasses.dataclass
class StopperTrainConfig:
    window: int = 5
    batch: int = 100
    learning_rate: float = 1e-3
    decay_steps: int = 500
    decay_rate: float = 0.95
    clip_norm: float = 5e2
    termination_step: int = 2000
    epochs: int = 100
    penalty: float = 10.0  # premature-stop penalty (regulation_weight)
    seed: int = 0


def generate_stopper_samples(code: Code, dia_model: torch.nn.Module,
                             trajectories: np.ndarray, labels: np.ndarray,
                             decoding_path: list[list[int]], batch: int = 128,
                             num_segments: int = 6,
                             device: str | torch.device = "cuda"):
    """Per-failure block minima + truth phase, ``batch`` frames a call.

    Returns (records, summary): records (M, P+1) float32 rows of the P
    block minima and the phase (1 success, -1 failure); undetected frames
    (a TEP closer than the truth) are dropped and counted in ``summary``,
    as ``query_teps_dis`` does.  ``dia_model`` is on ``device``."""
    dev = resolve_device(device)
    layout = segments.TepLayout.build(decoding_path, code.k, num_segments, dev)
    h = code.h_osd  # full-rank basis for the OSD elimination

    rec_list = []
    success = fails = undetected = 0
    with torch.no_grad():
        for lo in range(0, len(trajectories), batch):
            traj = torch.as_tensor(
                np.asarray(trajectories[lo:lo + batch], np.float32), device=dev)
            labs = torch.as_tensor(
                np.asarray(labels[lo:lo + batch], np.int32), device=dev)
            refined = dia_model.refine(traj)
            prep = engine.prepare(refined, traj[:, 0], labs, h, code.k)
            minima, _ = engine.block_discrepancy_minima(prep, layout, code.k)
            minima = minima.cpu().numpy()
            truth = prep.truth_discrepancy.cpu().numpy()
            overall = minima.min(axis=1)
            scale = np.maximum(np.abs(truth), 1.0)
            is_undetected = overall < truth - 1e-3 * scale
            is_success = np.abs(overall - truth) <= 1e-3 * scale
            phase = np.where(is_success, 1.0, -1.0)
            keep = ~is_undetected
            undetected += int(is_undetected.sum())
            success += int((is_success & keep).sum())
            fails += int((~is_success & keep).sum())
            rec = np.concatenate([minima[keep], phase[keep][:, None]], axis=1)
            rec_list.append(rec.astype(np.float32))
    records = (np.concatenate(rec_list) if rec_list
               else np.zeros((0, len(layout.bounds) + 1), np.float32))
    summary = {
        "success": success,
        "fail": fails,
        "undetected": undetected,
        "path_len": len(layout.bounds),
        "acc_block_sizes": layout.acc.tolist(),
    }
    return records, summary


def reform_windows(records: np.ndarray, window: int = 5):
    """Window dataset from block-minima records (``reform_inputs``).

    Returns (inputs (M', window+1), labels (M',)): the sorted window values
    and the window's position; label 1 iff the window holds the global
    minimum and the phase is 1."""
    if not len(records):
        return np.zeros((0, window + 1), np.float32), np.zeros((0,), np.float32)
    minima = records[:, :-1]
    phase = records[:, -1:]
    decodable = (phase != -1).astype(np.float32)
    global_min = minima.min(axis=1, keepdims=True)
    ins, labs = [], []
    for i in range(minima.shape[1] - window + 1):
        win = minima[:, i:i + window]
        win_min = win.min(axis=1, keepdims=True)
        label = ((global_min == win_min).astype(np.float32) * decodable)[:, 0]
        feats = np.concatenate(
            [np.sort(win, axis=1), np.full((len(win), 1), float(i))], axis=1)
        ins.append(feats)
        labs.append(label)
    return (np.concatenate(ins).astype(np.float32),
            np.concatenate(labs).astype(np.float32))


def stopper_loss(probs: torch.Tensor, one_hot: torch.Tensor,
                 weights: torch.Tensor, penalty: float) -> torch.Tensor:
    """Class-weighted CE, times ``penalty`` where the model stops
    (P[stop] > P[continue]) on a window that should continue
    (``predict_phase.py:123-135``); a sum over the batch."""
    probs = torch.clamp(probs, min=1e-30)
    ce = -(torch.log(probs) * one_hot).sum(-1)
    premature = (probs[:, 0] < probs[:, 1]) & (one_hot[:, 0] == 1.0)
    pen = torch.where(premature, penalty, 1.0)
    return (ce * pen * weights).sum()


def initial_stopper(width: int, seed: int,
                    device: torch.device) -> dia_mod.StopperFcn:
    """A ``StopperFcn`` at flax's initial distributions, drawn from
    ``seed`` (``models.dia.init_flax_``), on ``device``."""
    return dia_mod.init_flax_(dia_mod.StopperFcn(width), seed).to(device)


def train_stopper(inputs: np.ndarray, labels: np.ndarray,
                  config: StopperTrainConfig, seed: int = 0,
                  device: str | torch.device = "cuda"):
    """Train the stopper on the window dataset; ``seed`` permutes it
    (``np.random.default_rng(seed).permutation``), ``config.seed`` draws
    the initial weights.

    Returns ``(model, validation)``: the trained ``StopperFcn`` on
    ``device`` (``models.dia.stopper_engine_params`` feeds the walk) and
    ``success`` / ``late`` (F1) / ``premature`` (F2) over the dataset,
    ``total``, ``final_loss`` and ``initial_loss`` (the first and last
    steps' losses)."""
    cfg = config
    dev = resolve_device(device)
    perm = np.random.default_rng(seed).permutation(len(inputs))
    inputs, labels = inputs[perm], labels[perm]
    classes = labels.astype(int)
    counts = np.bincount(classes, minlength=2).astype(np.float64)
    class_w = len(labels) / (2.0 * np.maximum(counts, 1))
    x_all = torch.as_tensor(np.asarray(inputs, np.float32), device=dev)
    w_all = torch.as_tensor(class_w[classes].astype(np.float32), device=dev)
    oh_all = torch.as_tensor(np.eye(2, dtype=np.float32)[classes], device=dev)

    model = initial_stopper(cfg.window + 1, cfg.seed, dev)
    opt = StaircaseAdam(model.parameters(), cfg.learning_rate, cfg.decay_steps,
                        cfg.decay_rate, cfg.clip_norm)
    n = len(inputs)
    nb = max(1, n // cfg.batch)
    eff_batch = min(cfg.batch, n)

    @full_f32()  # the backward pass too
    def one_step(step_idx: int) -> torch.Tensor:
        lo = (step_idx % nb) * eff_batch
        sl = slice(lo, lo + eff_batch)
        opt.zero_grad()
        # L2 on the first layer (the reference's kernel_regularizer)
        loss = (stopper_loss(model(x_all[sl]), oh_all[sl], w_all[sl],
                             cfg.penalty)
                + 0.01 * model.dense1.weight.square().sum())
        loss.backward()
        opt.step()
        return loss.detach()

    total = min(cfg.termination_step, cfg.epochs * nb)
    losses = [one_step(i) for i in range(total)]

    # validation: S / F1 (late stop) / F2 (premature stop)
    with torch.no_grad():
        pred = model(x_all).argmax(1).cpu().numpy()
    validation = {
        "success": int((pred == classes).sum()),
        "late": int((classes > pred).sum()),
        "premature": int((classes < pred).sum()),
        "total": int(n),
        "final_loss": float(losses[-1]) if total else 0.0,
        "initial_loss": float(losses[0]) if total else 0.0,
    }
    return model.eval(), validation
