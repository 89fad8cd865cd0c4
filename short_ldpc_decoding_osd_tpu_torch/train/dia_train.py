"""DIA refiner training + order-pattern statistics sweep (stage 3, phase 1).

Port of ``short_ldpc_decoding_osd_tpu/train/dia_train.py`` (reference
``DL_Training_serial/nn_training.py:345-498``): train the selected DIA
refiner on NMS-failure trajectories with sigmoid CE (logits = -output),
then sweep the dataset collecting (a) MRB bit-error histograms before and
after the DIA and (b) the ratio-normalized 6-segment order-pattern
distribution that defines the decoding path.

Hyperparameters (``DL_Training_serial/globalmap.py:39-43``): Adam lr 1e-3,
staircase decay 0.95/500, per-tensor clip 5e2, termination 2000 steps.
Batches are taken in order, ``step % num_batches``, with no shuffle; the
dataset stays resident on the device.  Plain PyTorch autograd in IEEE f32
(``_device.full_f32``): no kernel has a backward pass.  The sweep's GF(2)
elimination is ``osd/path.py``'s, the GE kernel's dense load on the card.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from .._device import full_f32, resolve_device
from ..codes import Code
from ..models import dia as dia_mod
from ..osd import path as path_mod
from ..utils import checkpoint as ckpt_lib
from .optim import StaircaseAdam

BLOCK = 100  # steps between a log record and a checkpoint


@dataclasses.dataclass
class DIATrainConfig:
    model: str = "model_cnn"  # model_cnn | model_rnn1 | model_rnn2
    batch: int = 100
    learning_rate: float = 1e-3
    decay_steps: int = 500
    decay_rate: float = 0.95
    clip_norm: float = 5e2
    termination_step: int = 2000
    epochs: int = 100
    seed: int = 0


def initial_model(name: str, n: int, list_length: int, seed: int,
                  device: torch.device) -> torch.nn.Module:
    """The refiner ``name`` at flax's initial distributions, drawn from
    ``seed`` (``models.dia.init_flax_``), on ``device``."""
    model = dia_mod.make_dia(name, n, list_length)
    return dia_mod.init_flax_(model, seed).to(device)


def train_dia(code: Code, trajectories: np.ndarray, labels: np.ndarray,
              config: DIATrainConfig, ckpt_dir: str | None = None,
              log_fn: Callable[[dict], None] | None = None,
              device: str | torch.device = "cuda"):
    """Train the DIA refiner on (N, T+1, n) trajectories and (N, n) labels.

    Returns ``(model, history)``: the trained module on ``device`` and one
    record a block of 100 steps, ``{"step", "loss", "loss_mean"}`` (the
    block's last loss, as JAX logs it, and its mean).  With ``ckpt_dir``
    a checkpoint is saved after each block and at the end; a run resumes
    from the latest one at exactly its saved step (the checkpoint stores
    the completed-step count: no +1, JAX ``dia_train.py:69-73``) and then
    trains exactly what the uninterrupted run would have."""
    cfg = config
    dev = resolve_device(device)
    name = dia_mod.canonical_dia_name(cfg.model)
    list_length = trajectories.shape[1]
    model = initial_model(name, code.n, list_length, cfg.seed, dev)
    params = list(model.parameters())
    opt = StaircaseAdam(params, cfg.learning_rate, cfg.decay_steps,
                        cfg.decay_rate, cfg.clip_norm)
    start_step = 0
    if ckpt_dir:
        restored = ckpt_lib.load(ckpt_dir)
        if restored is not None:
            start_step, blob, _ = restored
            model.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in blob["params"].items()})
            opt.load_state_dict(blob["opt_state"])

    n_total = len(trajectories)
    num_batches = max(1, n_total // cfg.batch)
    eff_batch = min(cfg.batch, n_total)
    traj_dev = torch.as_tensor(np.asarray(trajectories, np.float32), device=dev)
    labs_dev = torch.as_tensor(np.asarray(labels, np.float32), device=dev)

    @full_f32()  # the backward pass too
    def one_step(step_idx: int) -> torch.Tensor:
        lo = (step_idx % num_batches) * eff_batch
        opt.zero_grad()
        loss = dia_mod.dia_loss(model.refine(traj_dev[lo:lo + eff_batch]),
                                labs_dev[lo:lo + eff_batch])
        loss.backward()
        opt.step()
        return loss.detach()

    def save(step):
        ckpt_lib.save(ckpt_dir, step, {
            "params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()},
            "opt_state": opt.state_dict()})

    total = min(cfg.termination_step, cfg.epochs * num_batches)
    history = []
    step = start_step
    while step < total:
        count = min(BLOCK, total - step)
        losses = torch.stack([one_step(step + i) for i in range(count)])
        step += count
        rec = {"step": step, "loss": float(losses[-1]),
               "loss_mean": float(losses.mean())}
        history.append(rec)
        if log_fn:
            log_fn(rec)
        if ckpt_dir:
            save(step)
    if ckpt_dir:
        save(step)
    return model.eval(), history


def pattern_statistics_sweep(code: Code, model: torch.nn.Module,
                             trajectories: np.ndarray, labels: np.ndarray,
                             batch: int = 256, num_segments: int = 6,
                             device: str | torch.device = "cuda") -> dict:
    """Post-training sweep (JAX ``dia_train.py:137-181``): DIA-refined
    reliabilities -> order-pattern counter, plus the MRB bit-error
    histograms of the channel slot (initial), the last iteration (final)
    and the refined values.  ``model`` is on ``device``."""
    dev = resolve_device(device)
    h = code.h_osd  # full-rank basis for the OSD elimination
    counter = path_mod.PatternCounter(code.k, num_segments)
    hists = {key: collections.Counter()
             for key in ("hist_initial", "hist_final", "hist_refined")}
    with torch.no_grad():
        for lo in range(0, len(trajectories), batch):
            traj = torch.as_tensor(
                np.asarray(trajectories[lo:lo + batch], np.float32), device=dev)
            labs = torch.as_tensor(
                np.asarray(labels[lo:lo + batch], np.int32), device=dev)
            refined = model.refine(traj)
            patterns, swap_len = path_mod.mrb_error_patterns(
                refined, labs, h, code.k, num_segments)
            counter.update(patterns, swap_len)
            for key, values in (("hist_initial", traj[:, 0]),
                                ("hist_final", traj[:, -1]),
                                ("hist_refined", refined)):
                hists[key].update(
                    path_mod.mrb_bit_error_histogram(values, labs, code.k))
    return {"pattern_counter": counter, **hists}
