"""Dense-rung NMS decode: the wrapper over the CUDA kernel K6.

Port of ``short_ldpc_decoding_osd_tpu/ops/nms_pallas.py``
(``decode_final_pallas`` :89 over ``_kernel`` :46).  The parity matrix ``h``
is a dense (m, n) 0/1 tensor on the frames' device, as the JAX ``h`` is a
traced array: the kernel (``csrc/nms_dense.cu``) derives the code's edge
structure from it on the card at launch, with no host tables and no cache
keyed on host bytes.  That is what separates K6 from K1
(``ops/nms_edge.py``), whose tables are built on the host from a concrete
``h``.

Semantics of the TPU kernel: scalar variants only (NMS-1/2/3, ENMS on the
extended H; NMS-r raises), the duplicate-at-minimum rule (:71-78), the sign
parity with zero rows (:61-69) and magnitudes clamped to 3.4e38 (a degree-1
row sends ``w_chk * 3.4e38``).  The plain PyTorch twin below runs the TPU
kernel's dense formulation, except that it sums each column total over the
m rows in ascending row order, one add at a time, as the kernel does over a
variable's edges; so under ``-fmad=false`` kernel and twin agree bit for
bit.  (``torch.sum``'s tree order would not.)

A wrapper runs the twin only when ``llr`` lies on the CPU; for a CUDA tensor
it launches the kernel or raises.  The TPU's VMEM block model
(``auto_block_frames`` :34-43) is not ported: the card's limit is the
shared memory of a block, and :func:`holds` states the rung's envelope by
shape.  At launch the kernel's iteration body (``csrc/nms_edge_body.cuh``)
needs the mask's largest degrees, which pick its compile-time bucket
(:func:`dense_plan`: two reductions on the card and one copy of two
integers to the host); a mask of degrees beyond every bucket raises.
"""

from __future__ import annotations

import functools

import torch

from .. import _kernels
from ..codes import tables
from . import nms_edge
from .nms import scalar_weights

# magnitude clamp of the TPU kernel, as the f32 the kernel compares with
BIG = 3.4e38
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a Hopper block can use
# frames per plain-twin chunk: bounds the twin's (B, m, n) temporaries
_PLAIN_CHUNK = 16_384


def smem_bytes(m: int, n: int, k: int = 0) -> int:
    """The dense rung's envelope by shape, in bytes: the slab tables and one
    frame of the densest (m, n) mask (dc = n, dv = m), cv (dc, m) and two
    n-vectors, for K6 (``k == 0``) or K7 (``k`` message bits, with its
    counters, G's encode tables at their largest (no unit column) and the
    frame's bits, message words and flags).  :func:`holds` keeps the rung
    to the shapes where this fits a block; a launch sizes its block by the
    mask's real degrees (:func:`dense_plan`)."""
    e = m * n
    tables = 2 + 2 * e  # dc, dv; edge_col (dc, m); var_edges (dv, n)
    frame = e + 2 * n  # cv (dc, m), total (n), llr (n)
    if k:
        kw = (k + 31) // 32
        tables += 16 + n + n * kw  # block counters, G's encode tables
        frame += n + kw + 2  # bits, message words, flags
    return 4 * (tables + frame)


def holds(m: int, n: int, k: int = 0) -> bool:
    """True when the dense-rung kernels take an (m, n) code (with ``k``
    message bits for K7): the five codes up to (66, 121) do, the (192, 384)
    and (176, 1056) ones do not."""
    return smem_bytes(m, n, k) <= SMEM_LIMIT


def _colsum(cv: torch.Tensor) -> torch.Tensor:
    """Column totals of cv (B, m, n) over the rows in ascending order, one
    add at a time (the kernel's order)."""
    s = torch.zeros_like(cv[:, 0])
    for c in range(cv.shape[1]):
        s = s + cv[:, c]
    return s


def _decode_chunk(h: torch.Tensor, llr: torch.Tensor, num_iterations: int,
                  weights) -> torch.Tensor:
    w_vc, w_chk, w_marg = weights
    edge = h > 0
    cv = torch.zeros((llr.shape[0],) + tuple(h.shape), dtype=torch.float32,
                     device=llr.device)
    for _ in range(num_iterations):
        total = _colsum(cv) + w_vc * llr
        vc = total[:, None, :] * h - cv
        neg = torch.logical_and(vc < 0, edge).sum(-1, keepdim=True,
                                                  dtype=torch.float32)
        parity = neg - 2.0 * torch.floor(neg * 0.5)
        anyzero = torch.logical_and(vc == 0, edge).any(-1, keepdim=True)
        row_sign = torch.where(anyzero, 0.0, 1.0 - 2.0 * parity)
        own = torch.where(vc > 0, 1.0, torch.where(vc < 0, -1.0, 0.0))
        edge_sign = row_sign * own * h
        mag = torch.clamp(vc.abs(), max=BIG)
        masked = torch.where(edge, mag, BIG)
        min1 = masked.amin(-1, keepdim=True)
        dup = torch.logical_and(masked <= min1, edge).sum(-1, keepdim=True) > 1
        strict2 = torch.where(masked > min1, masked, BIG).amin(-1, keepdim=True)
        min2 = torch.where(dup, min1, strict2)
        emag = torch.where(mag > min1, min1, min2) * h
        cv = w_chk * emag * edge_sign
    return _colsum(cv) + w_marg * llr


def _decode_dense_plain(h: torch.Tensor, llr: torch.Tensor,
                        num_iterations: int, weights) -> torch.Tensor:
    """Plain PyTorch twin of ``dense_decode_kernel`` (csrc/nms_dense.cu), in
    chunks of frames so its (B, m, n) temporaries stay bounded."""
    h = h.to(torch.float32)
    parts = [_decode_chunk(h, llr[i:i + _PLAIN_CHUNK], num_iterations, weights)
             for i in range(0, llr.shape[0], _PLAIN_CHUNK)]
    if not parts:
        return torch.empty_like(llr)
    return torch.cat(parts)


def dense_plan(h: torch.Tensor, k: int = 0, p: int = 0):
    """(dc, dv, lanes, plan): the largest check and variable degrees of
    the mask ``h`` on the card, the lanes its checks take at the split
    bucket (``nms_edge.split_lanes``) and the launch plan of K6 (``k ==
    0``) or K7 (``k`` message bits, ``p`` parity columns of G) for them:
    the slab tables (at the split bucket also its lane map, which the
    kernel builds beside them; for K7 the counters and G's encode tables)
    once a block, one frame region a frame.  The degrees and lanes are
    ``codes.tables``' (read once per mask)."""
    dc, dv = tables.degrees(h)
    lanes = nms_edge.split_lanes(h)
    m, n = h.shape
    table, extra = dc * m + dv * n, 0
    if k:
        kw = (k + 31) // 32
        table, extra = table + 16 + n + p * kw, kw + 2
    plan = nms_edge.launch_plan(m, n, dc, dv, extra, table, lanes)
    if plan is not None and plan.bucket == nms_edge.SPLIT_BUCKET:
        plan = nms_edge.launch_plan(m, n, dc, dv, extra,
                                    table + nms_edge.MAX_LANES + m, lanes)
    if plan is None:
        raise ValueError(f"no launch plan of the dense-rung kernels holds an "
                         f"({m}, {n}) mask of degrees ({dc}, {dv})")
    return dc, dv, lanes, plan


@functools.lru_cache(maxsize=16)
def max_blocks(plan: nms_edge.LaunchPlan, lanes: int, m: int, n: int,
               dc: int, dv: int, k: int, p: int, device_index: int) -> int:
    """The persistent grid of a full launch: the blocks of the plan that
    run at once on the card (``device_index`` keys the cache)."""
    del device_index  # the launch runs on the current device
    blocks = _kernels.library("nms_dense").dense_max_blocks(
        plan.bucket, plan.warps, plan.frames, lanes, m, n, dc, dv, k, p)
    if blocks < 1:
        raise RuntimeError(f"dense_max_blocks({plan}, k={k}) failed")
    return blocks


def check_mask(h: torch.Tensor, device: torch.device, k: int = 0) -> None:
    """Raise unless ``h`` is a contiguous (m, n) float32 tensor on
    ``device`` that the dense-rung kernels hold."""
    if (h.dtype != torch.float32 or h.dim() != 2 or not h.is_contiguous()
            or h.device != device):
        raise ValueError("h must be a contiguous (m, n) float32 tensor on "
                         f"{device}")
    m, n = h.shape
    if not holds(m, n, k):
        raise ValueError(
            f"the dense-rung kernel does not hold an ({m}, {n}) code: "
            f"{smem_bytes(m, n, k)} bytes of shared memory > {SMEM_LIMIT}")


def _decode_dense_kernel(h, llr, num_iterations, weights):
    if llr.dtype != torch.float32 or llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous (B, n) float32 tensor")
    check_mask(h, llr.device)
    m, n = h.shape
    batch = llr.shape[0]
    if llr.shape[1] != n:
        raise ValueError(f"llr has {llr.shape[1]} columns, h has {n}")
    if batch >= 2**31:
        raise ValueError(f"batch {batch} exceeds the kernel's int32 count")
    out = torch.empty_like(llr)
    dc, dv, lanes, plan = dense_plan(h)
    blocks = min(max_blocks(plan, lanes, m, n, dc, dv, 0, 0,
                            llr.device.index or 0),
                 -(-batch // plan.frames))
    status = _kernels.library("nms_dense").dense_decode(
        h.data_ptr(), llr.data_ptr(), out.data_ptr(), batch, m, n, dc, dv,
        num_iterations, plan.bucket, plan.warps, plan.frames, lanes, blocks,
        *weights, _kernels.stream_handle(llr.device))
    _kernels.check(status, "dense_decode")
    _kernels.LAUNCHES["dense_final"] += 1
    nms_edge.count_split(plan, batch)
    return out


def decode_final_dense(params: dict, h: torch.Tensor, llr: torch.Tensor,
                       num_iterations: int, variant: str = "NMS-1"
                       ) -> torch.Tensor:
    """Final-iteration soft outputs (B, n), ``colsum + w_marg * llr``
    (kernel K6 on CUDA).  ``h`` is the (m, n) 0/1 parity matrix as a
    float32 tensor on ``llr``'s device (the extended one for ENMS)."""
    weights = scalar_weights(params, variant)
    if not holds(*h.shape):
        raise ValueError(f"the dense-rung kernel does not hold an "
                         f"{tuple(h.shape)} code")
    if llr.device.type == "cpu":
        return _decode_dense_plain(h.to(llr.device), llr, num_iterations,
                                   weights)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return _decode_dense_kernel(h, llr, num_iterations, weights)
