"""Dense-rung fused Monte-Carlo counters: the wrapper over the CUDA kernel K7.

Port of ``short_ldpc_decoding_osd_tpu/ops/mc_pallas.py`` (``mc_fused`` :225
and ``fused_counters`` :268 over ``_mc_kernel`` :131).  One launch runs, per
frame: the hash sampler of ``ops/mc_hash.py`` keyed on (seed, frame id),
exactly as K3 and K4 draw; the encode ``msg . G mod 2`` through G's encode
tables (``nms_edge.encode_tables``, from ``codes.tables``), K3's and K4's
encode; the K6 body (``ops/nms_dense.py``) for T
iterations on the dense parity matrix, also a tensor on the card; and the
counters ``[frames, frame_err, bit_err, detected, undetected]`` by the rule
of ``mc_pallas.py:199-207``, int64 per block summed by the wrapper.

Because the sampler is shared, K7 and K4 (``nms_edge.fused_counters_edge``)
on the same seed decode the same frames with the same arithmetic.

Not ported, as TPU means: the on-core PRNG (:33-68) and the
``SLDPC_MSG_HARVEST`` sampler switch with ``msg_harvest_enabled`` (:71-87),
and ``block_frames`` (the card's block follows the launch plan of
``nms_dense.dense_plan``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .._device import resolve_device
from ..channel.awgn import sigma_for_snr
from ..codes import tables
from . import mc_hash, nms, nms_dense, nms_edge

_LANES = 5
# frames per plain-twin chunk: bounds the twin's (B, m, n) temporaries
_PLAIN_CHUNK = 65_536


def count_frames(soft: torch.Tensor, codeword: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """(5,) int64 counters of decoded frames by ``mc_pallas.py:199-207``,
    which is ``nms.frame_stats``'s rule: hard = soft < 0; frame_err = any
    bit wrong; detected = any parity violated; undetected = frame_err and
    not detected."""
    st = nms.frame_stats(soft, codeword, h)
    return torch.stack([
        torch.tensor(len(soft), dtype=torch.int64, device=soft.device),
        *(st[key].to(torch.int64).sum() for key in (
            "frame_error", "bit_errors", "detected_failure",
            "undetected_error"))])


def _mc_dense_plain(weights, seed: int, h: torch.Tensor, g: torch.Tensor,
                    num_iterations: int, batch: int, sigma: float,
                    mean: float) -> torch.Tensor:
    """Plain PyTorch twin of ``dense_mc_kernel`` (csrc/nms_dense.cu)."""
    total = torch.zeros(_LANES, dtype=torch.int64, device=h.device)
    for start in range(0, batch, _PLAIN_CHUNK):
        fid = torch.arange(start, min(batch, start + _PLAIN_CHUNK),
                           dtype=torch.int64, device=h.device)
        codeword, llr = mc_hash.sample(fid, seed, g, sigma, mean)
        soft = nms_dense._decode_dense_plain(h, llr, num_iterations, weights)
        total += count_frames(soft, codeword, h)
    return total


def _mc_dense_kernel(weights, seed: int, h: torch.Tensor, g: torch.Tensor,
                     num_iterations: int, batch: int, sigma: float,
                     mean: float) -> torch.Tensor:
    k, n = g.shape
    nms_dense.check_mask(h, h.device, k)
    if (g.dtype != torch.float32 or not g.is_contiguous() or g.device != h.device
            or h.shape[1] != n):
        raise ValueError("g must be a contiguous (k, n) float32 tensor on h's "
                         "device")
    if batch >= 2**31:
        raise ValueError(f"batch {batch} exceeds the kernel's int32 frame ids")
    m = h.shape[0]
    encode = tables.get(g, nms_edge.encode_tensor, h.device)
    p = nms_edge.parity_columns(encode, n, k)
    dc, dv, lanes, plan = nms_dense.dense_plan(h, k, p)
    blocks = min(nms_dense.max_blocks(plan, lanes, m, n, dc, dv, k, p,
                                      h.device.index or 0),
                 max(-(-batch // plan.frames), 1))
    partials = torch.empty((blocks, _LANES), dtype=torch.int64, device=h.device)
    status = _kernels.library("nms_dense").dense_mc(
        h.data_ptr(), encode.data_ptr(), p, partials.data_ptr(), batch, m, n,
        k, dc, dv, num_iterations, plan.bucket, plan.warps, plan.frames,
        lanes, blocks, seed, sigma, mean, *weights,
        _kernels.stream_handle(h.device))
    _kernels.check(status, "dense_mc")
    _kernels.LAUNCHES["mc_dense"] += 1
    nms_edge.count_split(plan, batch)
    return partials.sum(0)


def mc_fused(weights, seed: int, h: torch.Tensor, g: torch.Tensor,
             num_iterations: int, batch: int, sigma: float,
             mean: float = 1.0) -> torch.Tensor:
    """``batch`` hash frames of ``seed`` fully in one kernel (K7 on CUDA);
    returns (5,) int64 [frames, frame_errors, bit_errors, detected,
    undetected] on ``h``'s device.  ``weights`` = (w_vc, w_chk, w_marg);
    ``h`` (m, n) and ``g`` (k, n) are 0/1 float32 tensors on one device."""
    weights = tuple(float(np.float32(w)) for w in weights)
    seed = int(seed) & 0xFFFFFFFF
    sigma, mean = float(np.float32(sigma)), float(np.float32(mean))
    if not nms_dense.holds(h.shape[0], h.shape[1], g.shape[0]):
        raise ValueError(f"the dense-rung kernel does not hold an "
                         f"{tuple(h.shape)} code with k = {g.shape[0]}")
    if h.device.type == "cpu":
        return _mc_dense_plain(weights, seed, h, g.to(torch.float32),
                               num_iterations, batch, sigma, mean)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    return _mc_dense_kernel(weights, seed, h, g, num_iterations, batch, sigma,
                            mean)


def _decode_matrix(code, variant: str) -> np.ndarray:
    """The matrix the dense rung decodes ``variant`` on: ``code.h``, or
    ENMS's ``code.extended().h``."""
    return code.extended().h if variant == "ENMS" else code.h


def check_holds(code, variant: str) -> None:
    """Raise where K7 does not hold the matrix ``variant`` decodes on."""
    m, n = _decode_matrix(code, variant).shape
    if not nms_dense.holds(m, n, code.k):
        raise ValueError(f"rung 'dense': kernel K7 does not hold {variant}'s "
                         f"({m}, {n}) matrix of the code {code.name}")


def fused_counters(code, params: dict, variant: str, num_iterations: int,
                   snr_db: float, batch: int, seed: int,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """The harness's counter convention over :func:`mc_fused`: ``batch``
    hash frames of ``seed`` at ``snr_db`` (plain AWGN) on ``code.h``, or
    ENMS's ``code.extended().h`` (raising where K7 does not hold it),
    (5,) int64 on ``device``."""
    check_holds(code, variant)
    dev = resolve_device(device)
    h = tables.f32(_decode_matrix(code, variant), dev)
    g = tables.f32(code.g, dev)
    return mc_fused(nms.scalar_weights(params, variant), seed, h, g,
                    num_iterations, batch, sigma_for_snr(snr_db, code.rate))
