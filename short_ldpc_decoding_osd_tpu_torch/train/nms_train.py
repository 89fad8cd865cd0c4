"""NMS decoder training (stage 2 of the reference recipe).

Port of ``short_ldpc_decoding_osd_tpu/train/nms_train.py``, which replaces
``Ldpc_128_training/training_stage.py`` + ``training_block``
(``ms_decoder_dense.py:289-357``).  The reference trains on a fixed dataset
of ``num_batches`` pre-generated batches re-iterated across epochs; here a
generator seeded from (seed, batch id, micro-step) re-derives batch i of
every epoch as the same frames (the "fixed ring"), so no data files are
needed and the frames are made on the device.

Hyperparameters (``globalmap.py:41-45``): Adam, lr 0.01, staircase decay
0.95 every 500 steps, per-tensor gradient clip 5, termination at
min(total_steps, 1200).  Gradient accumulation and the NMS-r non-negative
projection are kept.  Plain PyTorch autograd: no kernel sits on this path
(the kernels decode forward only).

Decoder: NMS-r and codes above the dense rung's envelope train through the
padded edge layout on CUDA (``nms_edge_padded.train_select``, JAX
``nms_train.py:94-113``), everything else through the dense ``nms.decode``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .._device import full_f32, resolve_device
from ..channel.awgn import ChannelSpec, sample_batch
from ..codes import Code, tables
from ..ops import nms, nms_edge_padded
from ..utils import checkpoint as ckpt_lib
from .optim import StaircaseAdam


@dataclasses.dataclass
class NMSTrainConfig:
    variant: str = "NMS-1"
    num_iterations: int = 12
    snr_lo: float = 2.7
    snr_hi: float = 2.7
    batch: int = 100
    num_batches: int = 1000  # distinct batches in the (virtual) dataset
    learning_rate: float = 0.01
    decay_steps: int = 500
    decay_rate: float = 0.95
    clip_norm: float = 5.0
    termination_step: int = 1200
    grad_accumulation: int = 1
    seed: int = 0
    all_zeros: bool = False
    print_interval: int = 50
    record_interval: int = 50


def batch_seed(seed: int, batch_id: int, micro: int) -> int:
    """Generator seed of micro-batch ``micro`` of ring batch ``batch_id``."""
    return ((seed * 1_000_003 + batch_id) * 65_537 + micro) % 2**63


def _project_nonneg_(params: dict, variant: str) -> None:
    """NMS-r keeps its NN weights non-negative (keras ``non_neg``,
    ``ms_decoder_dense.py:16-17``) by projection after each update."""
    if variant == "NMS-r":
        with torch.no_grad():
            params["nn_w1"].clamp_(min=0.0)
            params["nn_w2"].clamp_(min=0.0)


def _setup(code: Code, cfg: NMSTrainConfig, dev: torch.device):
    """(h of the trained code as host numpy, ``loss_fn(params, llr, words)
    -> (loss, fer, ber)``, ``ring_batch(step_idx, micro) -> (llr,
    words)``)."""
    variant = cfg.variant
    train_code = code.extended() if variant == "ENMS" else code
    h_np = np.asarray(train_code.h)
    h = tables.f32(h_np, dev)
    gen_matrix = tables.f32(code.g, dev)
    edge_cols = nms.edge_columns(h_np) if variant == "NMS-r" else None
    spec = ChannelSpec.blend(cfg.snr_lo, cfg.snr_hi, code.rate)
    use_edge = nms_edge_padded.train_select(h_np, variant, dev)
    generator = torch.Generator(device=dev)

    def loss_fn(params, llr, words):
        if use_edge:
            outs = nms_edge_padded.decode_edge_padded(
                params, h_np, llr, cfg.num_iterations, variant)
        else:
            outs = nms.decode(params, h, llr, cfg.num_iterations, variant,
                              edge_cols)
        loss = nms.multi_iteration_loss(outs, words)
        st = nms.frame_stats(outs[-1].detach(), words, h)
        fer = st["frame_error"].to(torch.float32).mean()
        ber = st["bit_errors"].mean() / code.n
        return loss, fer, ber

    def ring_batch(step_idx, micro):
        generator.manual_seed(batch_seed(cfg.seed, step_idx % cfg.num_batches,
                                         micro))
        return sample_batch(generator, spec, gen_matrix, cfg.batch,
                            cfg.all_zeros)

    return h_np, loss_fn, ring_batch


def train_nms(code: Code, config: NMSTrainConfig, ckpt_dir: str | None = None,
              log_fn: Callable[[dict], None] | None = None,
              device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """Train an NMS variant; returns (params as tensors on ``device``,
    summary).  Every ``print_interval`` steps a record goes to ``log_fn``
    (the last step's loss, FER and BER, and the block's mean loss) and,
    with ``ckpt_dir``, a checkpoint is saved; a run resumes from the latest
    checkpoint there and then trains exactly what the uninterrupted run
    would have."""
    cfg = config
    dev = resolve_device(device)
    variant = cfg.variant
    h_np, loss_fn, ring_batch = _setup(code, cfg, dev)
    params = {k: v.to(dev).requires_grad_()
              for k, v in nms.init_params(variant, h_np, seed=cfg.seed).items()}
    opt = StaircaseAdam(params.values(), cfg.learning_rate, cfg.decay_steps,
                        cfg.decay_rate, cfg.clip_norm)
    start_step = 0
    if ckpt_dir:
        restored = ckpt_lib.load(ckpt_dir)
        if restored is not None:
            saved_step, blob, _ = restored
            with torch.no_grad():
                for k, v in blob["params"].items():
                    params[k].copy_(torch.as_tensor(v))
            opt.load_state_dict(blob["opt_state"])
            start_step = saved_step + 1

    @full_f32()  # the backward pass too
    def one_step(step_idx):
        opt.zero_grad()
        sums = torch.zeros(3, device=dev)
        for micro in range(cfg.grad_accumulation):
            loss, fer, ber = loss_fn(params, *ring_batch(step_idx, micro))
            loss.backward()
            sums += torch.stack([loss.detach(), fer, ber])
        mult = float(cfg.grad_accumulation)
        with torch.no_grad():
            for p in params.values():
                p.grad.div_(mult)
        opt.step()
        _project_nonneg_(params, variant)
        return sums / mult

    t0 = time.time()
    history = {"loss": [], "loss_mean": [], "fer": [], "ber": []}
    block = max(1, cfg.print_interval)
    step_idx = start_step
    while step_idx < cfg.termination_step:
        count = min(block, cfg.termination_step - step_idx)
        recs = torch.stack([one_step(step_idx + i) for i in range(count)])
        step_idx += count
        last = recs[-1].tolist()
        rec = {"step": step_idx, "loss": last[0], "fer": last[1],
               "ber": last[2], "loss_mean": float(recs[:, 0].mean()),
               "elapsed_s": time.time() - t0}
        for key in history:
            history[key].append(rec[key])
        if log_fn:
            log_fn(rec)
        if ckpt_dir:
            ckpt_lib.save(ckpt_dir, step_idx - 1, {
                "params": {k: v.detach().cpu().numpy() for k, v in params.items()},
                "opt_state": opt.state_dict()}, extra={"variant": variant})
    summary = {
        "steps": cfg.termination_step,
        "final_loss": history["loss"][-1] if history["loss"] else None,
        "final_fer": history["fer"][-1] if history["fer"] else None,
        "params": {k: v.detach().cpu().numpy().tolist() for k, v in params.items()},
        "history": history,
    }
    return params, summary


def ring_loss(code: Code, config: NMSTrainConfig, params: dict, steps,
              device: str | torch.device = "cuda") -> float:
    """Mean training loss of ``params`` over the ring batches that training
    steps ``steps`` draw (no update): the frames training saw there, so two
    parameter sets compare on identical data."""
    dev = resolve_device(device)
    _, loss_fn, ring_batch = _setup(code, config, dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in params.items()}
    with torch.no_grad():
        losses = [loss_fn(params, *ring_batch(i, micro))[0]
                  for i in steps for micro in range(config.grad_accumulation)]
    return float(torch.stack(losses).mean())
