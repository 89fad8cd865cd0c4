"""Edge-layout NMS decode: wrappers over the CUDA kernels K1 and K2.

Port of ``short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py``
(``decode_final_edge`` :339 over ``_decode_kernel`` :330, and
``decode_traj_edge`` :421 over ``_decode_traj_kernel`` :406).  The kernels
live in ``csrc/nms_edge.cu``; the plain PyTorch twins here repeat their
arithmetic step for step (same edge order, same tournament, same summation
order), so on the card kernel and twin agree to the last bit or close to it.

A wrapper runs the twin only when ``llr`` lies on the CPU; for a CUDA tensor
it launches the kernel or raises.  Only the scalar-normalized variants
(NMS-1/2/3, ENMS) have a kernel; NMS-r raises, as in JAX.

Layout: check-centric edges numbered slab-major, ``e = j*m + c`` for slot
``j`` of check ``c``.  Irregular rows pad with dummy edges (``edge_col < 0``)
that the kernel skips.  The TPU kernel's one-hot incidence matmuls, bf16
hi/lo split, lane packing and VMEM block model are MXU/VMEM artifacts and
have no counterpart here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from .nms import _weights


@functools.lru_cache(maxsize=16)
def _edge_layout_cached(h_bytes: bytes, m: int, n: int):
    h = np.frombuffer(h_bytes, dtype=np.uint8).reshape(m, n)
    degrees = h.sum(axis=1)
    if degrees.min() < 2:
        # a degree-1 check has no extrinsic message (and no second operand
        # for the min/submin tournament)
        raise ValueError(
            f"edge kernels need every check degree >= 2, got {int(degrees.min())}"
        )
    dc = int(degrees.max())
    edge_col = np.full((dc, m), -1, np.int32)
    for c in range(m):
        cols = np.flatnonzero(h[c])
        edge_col[: len(cols), c] = cols
    dv = int(h.sum(axis=0).max())
    var_edges = np.full((dv, n), -1, np.int32)
    for v in range(n):
        checks = np.flatnonzero(h[:, v])  # ascending check order
        slots = [int(np.flatnonzero(edge_col[:, c] == v)[0]) for c in checks]
        var_edges[: len(checks), v] = [j * m + c for j, c in zip(slots, checks)]
    edge_col.setflags(write=False)
    var_edges.setflags(write=False)
    return edge_col, var_edges


def edge_layout(h):
    """Edge tables of ``h``: ``edge_col`` (dc, m) int32, the variable of
    slot j of check c (-1 for a dummy edge), and ``var_edges`` (dv, n)
    int32, the edges of variable v in ascending check order (-1 padded)."""
    h = np.ascontiguousarray(np.asarray(h, dtype=np.uint8))
    return _edge_layout_cached(h.tobytes(), *h.shape)


_DEVICE_TABLES: dict = {}


def _tables_on(h, device: torch.device):
    """The edge tables as int32 tensors on ``device`` (cached per matrix)."""
    h = np.ascontiguousarray(np.asarray(h, dtype=np.uint8))
    key = (h.tobytes(), h.shape, str(device))
    if key not in _DEVICE_TABLES:
        edge_col, var_edges = edge_layout(h)
        _DEVICE_TABLES[key] = (
            torch.tensor(edge_col, device=device),
            torch.tensor(var_edges, device=device),
        )
    return _DEVICE_TABLES[key]


def _scalar_weights(params: dict, variant: str):
    if variant == "NMS-r":
        raise ValueError("NMS-r uses the dense decoder (neural check update)")
    return tuple(float(w) for w in _weights(params, variant))


def _decode_edge_plain(llr, h, num_iterations, weights, traj):
    """Plain PyTorch twin of ``csrc/nms_edge.cu`` (same operation order)."""
    w_vc, w_chk, w_marg = weights
    edge_col, var_edges = _tables_on(h, llr.device)
    dc, m = edge_col.shape
    batch, n = llr.shape
    num_edges = dc * m
    valid = edge_col >= 0
    cols = edge_col.clamp(min=0).long()
    # padded variable slots read a message slot that stays zero
    var_idx = torch.where(var_edges >= 0, var_edges, num_edges).long()
    cv = torch.zeros(batch, num_edges + 1, dtype=torch.float32, device=llr.device)
    outs = [llr] if traj else []
    soft = None
    for it in range(num_iterations + 1):
        s = torch.zeros(batch, n, dtype=torch.float32, device=llr.device)
        for d in range(var_idx.shape[0]):
            s = s + cv[:, var_idx[d]]
        if it > 0 and (traj or it == num_iterations):
            soft = s + w_marg * llr
            if traj:
                outs.append(soft)
        if it == num_iterations:
            break
        total = s + w_vc * llr
        msgs = cv[:, :num_edges].view(batch, dc, m)
        vc = total[:, cols] - msgs  # (B, dc, m)
        mag = torch.where(valid, vc.abs(), torch.inf)
        sgn = torch.where(vc > 0, 1.0, torch.where(vc < 0, -1.0, 0.0))
        sgn = torch.where(valid, sgn, 1.0)
        min1 = torch.full((batch, m), torch.inf, device=llr.device)
        min2 = torch.full((batch, m), torch.inf, device=llr.device)
        sign_prod = torch.ones((batch, m), device=llr.device)
        for j in range(dc):
            min2 = torch.minimum(min2, torch.maximum(min1, mag[:, j]))
            min1 = torch.minimum(min1, mag[:, j])
            sign_prod = sign_prod * sgn[:, j]
        emag = torch.where(mag > min1[:, None], (w_chk * min1)[:, None],
                           (w_chk * min2)[:, None])
        new = torch.where(valid, emag * (sign_prod[:, None] * sgn), 0.0)
        cv[:, :num_edges] = new.reshape(batch, num_edges)
    if traj:
        return torch.stack(outs, 0)
    if soft is None:  # zero iterations
        soft = w_marg * llr
    return soft


def _decode_edge_kernel(llr, h, num_iterations, weights, traj):
    if llr.dtype != torch.float32 or llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous (B, n) float32 tensor")
    edge_col, var_edges = _tables_on(h, llr.device)
    dc, m = edge_col.shape
    batch, n = llr.shape
    if var_edges.shape[1] != n:
        raise ValueError(f"llr has {n} columns, h has {var_edges.shape[1]}")
    if num_iterations == 0 and not traj:
        return weights[2] * llr
    shape = (num_iterations + 1, batch, n) if traj else (batch, n)
    out = torch.empty(shape, dtype=torch.float32, device=llr.device)
    lib = _kernels.library("nms_edge")
    status = lib.nms_edge_decode(
        llr.data_ptr(), out.data_ptr(), edge_col.data_ptr(),
        var_edges.data_ptr(), batch, n, m, dc, var_edges.shape[0],
        num_iterations, *weights, int(traj), _kernels.stream_handle(llr.device),
    )
    _kernels.check(status, "nms_edge_decode")
    _kernels.LAUNCHES["nms_edge_traj" if traj else "nms_edge_final"] += 1
    return out


def _decode(params, h, llr, num_iterations, variant, traj):
    weights = _scalar_weights(params, variant)
    if llr.device.type == "cpu":
        return _decode_edge_plain(llr, h, num_iterations, weights, traj)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return _decode_edge_kernel(llr, h, num_iterations, weights, traj)


def decode_final_edge(params: dict, h, llr: torch.Tensor, num_iterations: int,
                      variant: str = "NMS-1") -> torch.Tensor:
    """Final-iteration soft outputs (B, n), ``colsum + w_marg * llr``
    (kernel K1 on CUDA).  ``h`` is the host (m, n) 0/1 parity matrix."""
    return _decode(params, h, llr, num_iterations, variant, traj=False)


def decode_traj_edge(params: dict, h, llr: torch.Tensor, num_iterations: int,
                     variant: str = "NMS-1") -> torch.Tensor:
    """Per-iteration soft-output trajectories (T+1, B, n) in the
    ``nms.decode`` convention: slot 0 = llr, slot t = colsum after t
    updates + w_marg * llr (kernel K2 on CUDA).  Full f32 throughout, the
    JAX kernel's ``mode="highest"``."""
    return _decode(params, h, llr, num_iterations, variant, traj=True)
