"""NMS decoding on the padded edge layout, in plain PyTorch: the decoder for
codes no kernel takes (NMS-r's among them) and for training (NMS-r, large
codes).

Port of ``short_ldpc_decoding_osd_tpu/ops/nms_edge_xla.py``.  Messages live
in the padded edge layout (B, dc, m): slot q of check row i, dc the largest
check degree, irregular rows padded with slots that are inert in the
tournament, the sign parity and the column sums.  For WiMAX (1056, 880)
that is 53x smaller than the dense (B, m, n) tensor of ``ops/nms.py``.

Per iteration the update is exactly ``ops.nms``'s dense update: min/submin
over the other edges of the row with the first-argmin rule for a duplicated
minimum, the sign by negative-count parity with zero propagation, the
neural check update of NMS-r (regular check degree only, as
``nms.edge_columns``), and the variant weightings of ``nms._weights``.
Column totals are gathers of each variable's edges summed in ascending
check order, and the totals go back to the edges by a gather: JAX's one-hot
incidence matmuls (``incidence_matrices`` :68) and their ``mode``
precisions (:183-187) are MXU means with no counterpart here.  So the
result differs from the dense decoder only by f32 addition order, and the
functions are differentiable (the trainer uses them).

JAX leaves this module to XLA; the port leaves it to PyTorch: it has no
hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import full_f32
from ..codes import tables
from ..utils import profiling
from . import nms, nms_dense, nms_edge

__all__ = ["edge_layout", "supports", "auto_select", "train_select",
           "decode_edge_padded", "decode_final_edge_padded"]


def edge_layout(h) -> tuple[np.ndarray, np.ndarray]:
    """Padded edge layout: (edge_cols (m, dc) int32, real (m, dc) bool).
    Row i's first deg(i) slots hold its columns in ascending order; padding
    slots carry column 0 with ``real=False``."""
    rows = [np.flatnonzero(r) for r in np.asarray(h)]
    dc = max(len(r) for r in rows)
    cols = np.zeros((len(rows), dc), np.int32)
    real = np.zeros((len(rows), dc), bool)
    for i, r in enumerate(rows):
        cols[i, : len(r)] = r
        real[i, : len(r)] = True
    return cols, real


def supports(h, variant: str) -> bool:
    """True iff ``variant`` decodes here on ``h``: scalar variants always,
    NMS-r only with a regular check degree."""
    if variant != "NMS-r":
        return True
    degs = np.asarray(h).sum(axis=1)
    return bool((degs == degs[0]).all())


# the smallest batch at which NMS-r takes this layout by default on a code
# its edge kernel does not hold: on an H100 (chip_smoke.py) the plain dense
# step was faster at 1,024 CCSDS frames, where both are bound by host
# launches, and this layout from 2,048 frames up (1.9x at 262,144, in about
# a third of the memory)
NMS_R_MIN_BATCH = 2048


def auto_select(h, variant: str, device: str | torch.device,
                batch: int) -> bool:
    """The port's rule for serving ``variant`` on ``h`` through this module
    by default, for steps of ``batch`` frames: on CUDA only; NMS-r whenever
    :func:`supports`, its own edge kernel does not hold the code
    (``nms_edge.kernel_holds``) and ``batch >= NMS_R_MIN_BATCH``; a scalar
    variant only when neither K1 (``nms_edge.kernel_holds``) nor K6
    (``nms_dense.holds``) takes the code."""
    if torch.device(device).type != "cuda" or not supports(h, variant):
        return False
    if variant == "NMS-r":
        return (batch >= NMS_R_MIN_BATCH
                and not nms_edge.kernel_holds(h, variant))
    return not (nms_edge.kernel_holds(h) or nms_dense.holds(*np.shape(h)))


def _layout_tables(h, device):
    """The layout's flat tables as tensors on ``device`` (a
    ``codes.tables`` item, so a decode copies nothing from the host)."""
    m, n = h.shape
    cols, real = edge_layout(h)
    dc = cols.shape[1]
    # dc-major flat edge e = q * m + i, as the (B, dc, m) work tensors
    flat_cols = cols.T.reshape(-1).astype(np.int64)
    flat_real = real.T.reshape(-1)
    # each variable's edges in ascending check order; padding reads slot
    # dc * m, a zero column appended to the flat messages
    dv = int(h.sum(axis=0).max())
    var_idx = np.full((dv, n), dc * m, np.int64)
    for v in range(n):
        checks = np.flatnonzero(h[:, v])
        for d, i in enumerate(checks):
            q = int(np.flatnonzero(cols[i] == v)[0])
            var_idx[d, v] = q * m + i
    # NMS-r: row slot p's dc-1 other slots
    loo_idx = np.array([[q for q in range(dc) if q != p] for p in range(dc)],
                       np.int64).reshape(dc, dc - 1)
    return tuple(torch.tensor(a, device=device)
                 for a in (flat_cols, flat_real, var_idx, loo_idx))


def _row_signs(vc: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Edge sign = product of the other edges' signs by negative-count
    parity over the dc axis; a zero edge zeroes the row; padding inert."""
    neg = torch.logical_and(vc < 0, real).sum(-2, keepdim=True,
                                              dtype=vc.dtype)
    parity = neg - 2.0 * torch.floor(neg * 0.5)
    anyzero = torch.logical_and(vc == 0, real).any(-2, keepdim=True)
    row_sign = torch.where(anyzero, 0.0, 1.0 - 2.0 * parity)
    return row_sign * nms._sign(vc) * real


def _check_update_minsum_edge(vc, real, w_chk):
    """``nms._check_update_minsum`` on the (B, dc, m) layout: the row
    minimum over the other edges (submin for the first argmin slot), times
    the other edges' signs (no gradient through the sign)."""
    edge_sign = _row_signs(vc, real)
    mag = torch.clamp(vc.abs(), 0.0, nms._CLIP)
    masked = torch.where(real, mag, torch.inf)
    min1 = masked.amin(-2, keepdim=True)
    arg1 = nms.first_argmin(masked, -2)
    slots = torch.arange(vc.shape[-2], device=vc.device)[:, None]
    not_first = slots != arg1[:, None, :]
    min2 = torch.where(not_first, masked, torch.inf).amin(-2, keepdim=True)
    edge_mag = torch.where(mag > min1, min1, min2) * real
    return w_chk * edge_mag * edge_sign.detach()


@full_f32()
def _check_update_neural_edge(vc, real, params, loo_idx):
    """``nms._check_update_neural`` on the (B, dc, m) layout: per edge, the
    sorted magnitudes of the row's other dc-1 edges (``loo_idx`` (dc, dc-1)
    names them) through the non-negative 2-layer NN (regular check degree,
    so no padding).  The NN runs on the (B, m, dc, dc-1) view, as the
    dense update does, so the sort and the products run on the last axis.
    The sort is not stable: its values are the same, and on CUDA a stable
    sort of this shape takes about four times as long.

    Span ``nmsr.check``, around spans ``nmsr.sort`` (the gather and the
    leave-one-out sort) and ``nmsr.net`` (the two products); counts the
    edges updated, ``nmsr.edge_updates``."""
    with profiling.span("nmsr.check"):
        profiling.count("nmsr.edge_updates", vc.numel())
        edge_sign = _row_signs(vc, real)
        with profiling.span("nmsr.sort"):
            rows = vc.abs().transpose(1, 2)  # (B, m, dc)
            loo = torch.sort(rows[:, :, loo_idx], dim=-1).values
        with profiling.span("nmsr.net"):
            mags = ((loo @ params["nn_w1"]) @ params["nn_w2"])[..., 0]  # (B, m, dc)
        return mags.transpose(1, 2) * edge_sign.detach()


def _build(params, h, variant, device):
    if variant == "NMS-r" and not supports(h, variant):
        raise ValueError("NMS-r's leave-one-out check update requires a "
                         "regular check degree (matching nms.edge_columns)")
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    w_vc, w_chk, w_marg = nms._weights(params, variant)
    flat_cols, flat_real, var_idx, loo_idx = tables.get(h, _layout_tables,
                                                        device)
    m = np.shape(h)[0]
    dc = len(flat_cols) // m
    real = flat_real.view(dc, m)

    def colsum(cv):
        flat = torch.cat([cv.reshape(cv.shape[0], dc * m),
                          cv.new_zeros((cv.shape[0], 1))], 1)
        s = flat[:, var_idx[0]]
        for d in range(1, var_idx.shape[0]):
            s = s + flat[:, var_idx[d]]
        return s

    def update(cv, weighted_in):
        total = colsum(cv) + weighted_in
        at_edges = torch.where(flat_real, total[:, flat_cols], 0.0)
        vc = at_edges.view(cv.shape) - cv
        if variant == "NMS-r":
            return _check_update_neural_edge(vc, real, params, loo_idx)
        return _check_update_minsum_edge(vc, real, w_chk)

    def soft_of(cv, llr):
        return colsum(cv) + w_marg * llr

    return update, soft_of, (dc, m), w_vc


def decode_edge_padded(params: dict, h, llr: torch.Tensor,
                       num_iterations: int, variant: str = "NMS-1"
                       ) -> torch.Tensor:
    """(T+1, B, n) per-iteration soft outputs (slot 0 = channel input), the
    contract of ``nms.decode`` (JAX ``decode_edge_xla`` :225).  ``h`` is the
    host (m, n) 0/1 parity matrix.  Counts its frames, ``padded.frames``."""
    profiling.count("padded.frames", llr.shape[0])
    update, soft_of, shape, w_vc = _build(params, h, variant, llr.device)
    weighted_in = w_vc * llr
    cv = llr.new_zeros((llr.shape[0],) + shape)
    softs = [llr]
    for _ in range(num_iterations):
        cv = update(cv, weighted_in)
        softs.append(soft_of(cv, llr))
    return torch.stack(softs, 0)


def decode_final_edge_padded(params: dict, h, llr: torch.Tensor,
                             num_iterations: int, variant: str = "NMS-1"
                             ) -> torch.Tensor:
    """Last-iteration soft output (B, n) only (JAX
    ``decode_final_edge_xla`` :241); counts its frames, ``padded.frames``."""
    profiling.count("padded.frames", llr.shape[0])
    update, soft_of, shape, w_vc = _build(params, h, variant, llr.device)
    weighted_in = w_vc * llr
    cv = llr.new_zeros((llr.shape[0],) + shape)
    for _ in range(num_iterations):
        cv = update(cv, weighted_in)
    return soft_of(cv, llr)


def train_select(h, variant: str, device: str | torch.device) -> bool:
    """The trainer's rule (JAX ``nms_train.py:94-113``): on CUDA, NMS-r
    whenever :func:`supports`, and a scalar variant on a code above the
    dense rung's envelope (``nms_dense.holds``), whose dense (B, m, n)
    messages the edge layout shrinks; else the dense ``nms.decode``."""
    if torch.device(device).type != "cuda" or not supports(h, variant):
        return False
    return variant == "NMS-r" or not nms_dense.holds(*np.shape(h))
