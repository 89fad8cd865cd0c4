"""Two-phase early-termination Monte-Carlo cascade (kernel K8).

Port of ``short_ldpc_decoding_osd_tpu/ops/mc_cascade.py:112-337``
(``_phase1_kernel``, ``_phase2_kernel``, ``_cascade_jit``, ``_CAP_CACHE``,
``cascade_counters``):

* **phase 1** (K8a) decodes every frame for ``t1`` iterations, banks the
  counters of the converged frames (zero syndrome: their decision is final)
  and flags the rest;
* a fixed-capacity compaction keeps the first ``cap`` flagged frame ids in
  frame order, padded with -1 (``jnp.nonzero(size=cap, fill_value=-1)``;
  here ``torch.nonzero`` and a fill on the frames' device);
* **phase 2** (K8b) regenerates those frames from (seed, frame id) and
  decodes them from scratch for all T iterations.

The capacity comes from the unconverged share of a calibration run cached
per operating point (``_CAP_CACHE``), plus a 6-sigma and two-block margin; a
run whose phase 2 counted fewer frames than phase 1 flagged is repeated
with double the capacity, so every frame is counted.

Both phases are ``mc_frames`` launches of ``csrc/mc_fused.cu`` on CUDA (the
STAGE and COUNT forms that K3 chains too) and its plain twin in
``ops/nms_edge.py`` on the CPU.  The frames are the hash frames of
``ops/mc_hash.py``, so for one seed K8 decodes the frames K3 and K4 decode:
with no K3 overflow the two give the same counters.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from . import nms_edge

_CAP_CACHE: dict = {}


def phase1(mc: nms_edge.MCSetup, t1: int, batch: int):
    """Frames ``0..batch-1`` through ``t1`` iterations (kernel K8a on
    CUDA): (5,) int64 counters of the converged frames and the (batch,)
    int32 flags, nonzero for a frame not converged at ``t1`` (its value is
    ``1 | bit_errors << 1``)."""
    if mc.device.type == "cpu":
        counters, flags, _ = nms_edge._mc_frames_plain(mc, t1, batch,
                                                        stage=True)
    else:
        counters, flags, _ = nms_edge._mc_frames_kernel(mc, t1, batch,
                                                         stage=True)
        _kernels.LAUNCHES["cascade_p1"] += 1
    return counters[:5], flags


def phase2(mc: nms_edge.MCSetup, num_iterations: int,
           ids: torch.Tensor) -> torch.Tensor:
    """The frames ``ids`` (int32, -1 = padding, counts nothing) decoded from
    scratch through ``num_iterations`` iterations (kernel K8b on CUDA):
    (5,) int64 counters."""
    if mc.device.type == "cpu":
        counters, _, _ = nms_edge._mc_frames_plain(mc, num_iterations,
                                                   len(ids), ids)
    else:
        counters, _, _ = nms_edge._mc_frames_kernel(mc, num_iterations,
                                                    len(ids), ids)
        _kernels.LAUNCHES["cascade_p2"] += 1
    return counters[:5]


def fixed_capacity_ids(flags: torch.Tensor, cap: int) -> torch.Tensor:
    """The first ``cap`` flagged frame ids in frame order, -1 padded to
    ``cap`` (int32, on the flags' device)."""
    found = torch.nonzero(flags)[:cap, 0]
    ids = torch.full((cap,), -1, dtype=torch.int32, device=flags.device)
    ids[: len(found)] = found.to(torch.int32)
    return ids


def capacity(frac: float, batch: int, block_frames: int) -> int:
    """Phase-2 capacity for an unconverged share ``frac``: the mean plus a
    6-sigma and two-block margin, in whole blocks, at most ``batch``."""
    margin = 6.0 * np.sqrt(max(frac * (1 - frac) * batch, 1.0)) + 2 * block_frames
    return min(batch, -(-int(frac * batch + margin) // block_frames) * block_frames)


def cascade_counters(code, params: dict, variant: str, num_iterations: int,
                     snr_db: float, batch: int, seed: int, t1: int = 4,
                     block_frames: int = 512,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Early-termination counters [frames, frame_err, bit_err, detected,
    undetected], (5,) int64 on ``device``: frames converged at ``t1`` are
    judged there, the rest after ``num_iterations``.  The counted frames
    always equal ``batch``.  ``block_frames`` rounds the phase-2 capacity."""
    mc = nms_edge.mc_setup(code, params, variant, snr_db, seed, device)
    key = (code.name, variant, t1, round(float(snr_db), 3),
           tuple(np.round(np.asarray(mc.weights, np.float32), 5).tolist()))
    frac = _CAP_CACHE.get(key)
    if frac is None:
        calib = min(batch, 131_072)
        c1, _ = phase1(mc, t1, calib)
        frac = 1.0 - float(c1[0]) / calib
        _CAP_CACHE[key] = frac
    cap = capacity(frac, batch, block_frames)
    while True:
        c1, flags = phase1(mc, t1, batch)
        c2 = phase2(mc, num_iterations, fixed_capacity_ids(flags, cap))
        overflow = int(batch - c1[0] - c2[0])  # flagged frames past `cap`
        if overflow <= 0 or cap >= batch:
            return c1 + c2
        cap = min(batch, 2 * cap)  # rare: run again with double the capacity
