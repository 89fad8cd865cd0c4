"""Batched normalized-min-sum (NMS) belief propagation, dense plain PyTorch.

Port of ``short_ldpc_decoding_osd_tpu/ops/nms.py`` (reference
``Ldpc_128_training/ms_decoder_dense.py:65-241``): a fixed number of
iterations over a dense ``(B, m, n)`` message tensor, for every variant.
It is the port's oracle for the edge-layout kernels in ``ops/nms_edge.py``.

Variants (weights pass through softplus, init -0.048 ~ softplus 0.67):

* ``NMS-1``: one shared check-node normalization scalar.
* ``NMS-2``: + one shared bit scalar (vc update and marginalization).
* ``NMS-3``: two bit scalars (vc update, marginalization) + the check scalar.
* ``NMS-r``: check-node magnitude from a non-negative 2-layer NN over the
  sorted magnitudes of the other row entries; bit scalars as NMS-3.
* ``ENMS``: NMS-1 on the extended parity matrix (``Code.extended``).

Parameters are a flat dict of tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import full_f32
from ..codes import tables
from ..utils import profiling

VARIANTS = ("NMS-1", "NMS-2", "NMS-3", "NMS-r", "ENMS")

_INIT = -0.048
_CLIP = 1e30


def first_index(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where there is none).

    ``jnp.argmax`` over 0/1 returns the first occurrence; this helper states
    that rule explicitly rather than relying on the tie order of a CUDA
    ``argmax``/``argmin`` reduction."""
    size = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = size
    iota = torch.arange(size, device=mask.device).view(shape)
    idx = torch.where(mask, iota, size).amin(dim=dim)
    return torch.where(idx == size, 0, idx)


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``argmin`` with the first-occurrence tie rule of ``jnp.argmin``."""
    return first_index(x == x.amin(dim=dim, keepdim=True), dim)


def edge_columns(h: np.ndarray) -> np.ndarray:
    """Static per-check edge column indices, shape (m, dc); regular check
    degree only (the NMS-r neural check update)."""
    rows = [np.flatnonzero(r) for r in np.asarray(h)]
    dc = max(len(r) for r in rows)
    if any(len(r) != dc for r in rows):
        raise ValueError("NMS-r requires a regular check degree")
    return np.stack(rows).astype(np.int64)


def init_params(variant: str, h: np.ndarray | None = None, seed: int = 0,
                device: str | torch.device = "cpu") -> dict:
    """Initial parameter dict for a decoder variant."""
    def scalar():
        return torch.tensor([_INIT], dtype=torch.float32, device=device)

    if variant in ("NMS-1", "ENMS"):
        return {"check": scalar()}
    if variant == "NMS-2":
        return {"check": scalar(), "bit": scalar()}
    if variant == "NMS-3":
        return {"check": scalar(), "bit1": scalar(), "bit2": scalar()}
    if variant == "NMS-r":
        dc = int(np.asarray(h).sum(axis=1).max())
        rng = np.random.default_rng(seed)
        limit1 = np.sqrt(6.0 / (dc - 1 + 4))
        limit2 = np.sqrt(6.0 / (4 + 1))
        w1 = np.abs(rng.uniform(-limit1, limit1, (dc - 1, 4)))
        w2 = np.abs(rng.uniform(-limit2, limit2, (4, 1)))
        return {
            "bit1": scalar(),
            "bit2": scalar(),
            "nn_w1": torch.tensor(w1, dtype=torch.float32, device=device),
            "nn_w2": torch.tensor(w2, dtype=torch.float32, device=device),
        }
    raise ValueError(f"unknown NMS variant {variant!r}")


def _weights(params: dict, variant: str):
    """(w_vc, w_chk, w_marg) effective multipliers for a variant (0-d
    tensors; ``w_chk`` is None for NMS-r)."""
    sp = F.softplus
    if variant in ("NMS-1", "ENMS"):
        w_chk = sp(params["check"][0])
        one = torch.ones((), dtype=w_chk.dtype, device=w_chk.device)
        return one, w_chk, one
    if variant == "NMS-2":
        wb = sp(params["bit"][0])
        return wb, sp(params["check"][0]), wb
    if variant == "NMS-3":
        return sp(params["bit1"][0]), sp(params["check"][0]), sp(params["bit2"][0])
    if variant == "NMS-r":
        return sp(params["bit1"][0]), None, sp(params["bit2"][0])
    raise ValueError(variant)


def scalar_weights(params: dict, variant: str) -> tuple:
    """(w_vc, w_chk, w_marg) as host floats, the operands of the decode
    kernels; NMS-r (neural check update) has none and raises."""
    if variant == "NMS-r":
        raise ValueError("NMS-r has no decode kernel (neural check update): "
                         "use nms.decode or the padded edge layout")
    return tuple(float(w) for w in _weights(params, variant))


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, 0.0)).to(x.dtype)


def _row_sign_parity(vc: torch.Tensor, h: torch.Tensor):
    """(row_sign, edge_sign): product of the row's edge signs; a zero edge
    zeroes the whole row (``tf.sign`` semantics)."""
    edge = h > 0
    negcount = (torch.logical_and(vc < 0, edge)).to(vc.dtype).sum(-1, keepdim=True)
    parity = negcount - 2.0 * torch.floor(negcount * 0.5)
    anyzero = torch.logical_and(vc == 0, edge).any(-1, keepdim=True)
    row_sign = torch.where(anyzero, 0.0, 1.0 - 2.0 * parity)
    return row_sign, row_sign * _sign(vc) * h


def _check_update_minsum(vc, h, w_chk):
    """Min-sum check update on the dense masked tensor: each edge gets the
    row minimum over the other edges (submin for the first argmin edge; a
    duplicated minimum therefore yields the minimum again), times the
    product of the other edges' signs (no gradient through the sign)."""
    _, edge_sign = _row_sign_parity(vc, h)
    mag = torch.clamp(vc.abs(), 0.0, _CLIP)
    masked = torch.where(h > 0, mag, torch.inf)
    min1 = masked.amin(-1, keepdim=True)
    arg1 = first_argmin(masked, -1)
    cols = torch.arange(masked.shape[-1], device=vc.device)
    not_first = cols != arg1[..., None]
    min2 = torch.where(not_first, masked, torch.inf).amin(-1, keepdim=True)
    edge_mag = torch.where(mag > min1, min1, min2) * h
    return w_chk * edge_mag * edge_sign.detach()


@full_f32()
def _check_update_neural(vc, h, params, edge_cols):
    """NMS-r: per edge, the sorted magnitudes of the row's other dc-1 edges
    through a non-negative 2-layer linear NN.  Span ``nmsr.check`` around
    ``nmsr.sort`` and ``nmsr.net``, and counter ``nmsr.edge_updates``, as
    the padded layout's update records them."""
    m, dc = edge_cols.shape
    with profiling.span("nmsr.check"):
        profiling.count("nmsr.edge_updates", vc.shape[0] * m * dc)
        _, edge_sign = _row_sign_parity(vc, h)
        cols = torch.as_tensor(edge_cols, device=vc.device)
        with profiling.span("nmsr.sort"):
            compact = torch.gather(
                vc.abs(), 2, cols[None].expand(vc.shape[0], m, dc)
            )  # (B, m, dc)
            loo_idx = torch.tensor(
                [[q for q in range(dc) if q != p] for p in range(dc)],
                device=vc.device)
            loo = torch.sort(compact[:, :, loo_idx], dim=-1).values  # (B, m, dc, dc-1)
        with profiling.span("nmsr.net"):
            mags = ((loo @ params["nn_w1"]) @ params["nn_w2"])[..., 0]  # (B, m, dc)
        dense = torch.zeros_like(vc).scatter(2, cols[None].expand_as(mags), mags)
        return dense * edge_sign.detach()


def _iterate(params, h, llr, num_iterations, variant, edge_cols, keep_all):
    # the parameters on the frames' device, as the padded edge layout takes
    # them: callers keep the scalar variants' weights on the host for the
    # kernel wrappers, and NMS-r's network must run beside its frames
    params = {k: torch.as_tensor(v).to(llr.device) for k, v in params.items()}
    w_vc, w_chk, w_marg = _weights(params, variant)
    h = tables.f32(h, llr.device)
    weighted_in = (w_vc * llr)[:, None, :]
    cv = torch.zeros((llr.shape[0],) + tuple(h.shape), dtype=llr.dtype,
                     device=llr.device)
    softs = []
    for _ in range(num_iterations):
        total = cv.sum(1)[:, None, :] + weighted_in
        vc = total * h - cv
        if variant == "NMS-r":
            cv = _check_update_neural(vc, h, params, edge_cols)
        else:
            cv = _check_update_minsum(vc, h, w_chk)
        if keep_all:
            softs.append(cv.sum(1) + w_marg * llr)
    if keep_all:
        return torch.stack([llr] + softs, 0)
    return cv.sum(1) + w_marg * llr


def decode(params: dict, h, llr: torch.Tensor, num_iterations: int,
           variant: str = "NMS-1", edge_cols=None) -> torch.Tensor:
    """(T+1, B, n) per-iteration soft outputs; slot 0 is the channel input.

    ``h`` is the (m, n) 0/1 parity matrix, ``llr`` (B, n) channel LLR proxies
    (positive ~ bit 0), ``edge_cols`` the (m, dc) table NMS-r needs."""
    return _iterate(params, h, llr, num_iterations, variant, edge_cols, True)


def decode_final(params: dict, h, llr: torch.Tensor, num_iterations: int,
                 variant: str = "NMS-1", edge_cols=None) -> torch.Tensor:
    """Last-iteration soft output (B, n) only."""
    return _iterate(params, h, llr, num_iterations, variant, edge_cols, False)


def multi_iteration_loss(soft_outputs: torch.Tensor, labels) -> torch.Tensor:
    """Sum over iterations 1..T of sigmoid cross entropy with logits
    ``-soft_output``."""
    logits = -soft_outputs[1:]
    z = torch.as_tensor(labels, device=logits.device)[None].to(logits.dtype)
    ce = (torch.clamp(logits, min=0.0) - logits * z
          + torch.log1p(torch.exp(-logits.abs())))
    return ce.sum()


def frame_stats(soft_last: torch.Tensor, labels: torch.Tensor, h) -> dict:
    """Per-frame decoding statistics (``ms_test.py:36-54``):

    * ``frame_error``: any bit mismatch vs the transmitted codeword;
    * ``bit_errors``: mismatching bits per frame;
    * ``detected_failure``: nonzero syndrome (these frames go to OSD);
    * ``undetected_error``: zero syndrome but wrong codeword (UFER, excluded
      from the OSD failure set)."""
    h = tables.f32(h, soft_last.device)
    hard = (soft_last < 0).to(torch.float32)
    err = hard != labels.to(torch.float32)
    frame_error = err.any(-1)
    synd = hard @ h.T
    synd = synd - 2.0 * torch.floor(synd * 0.5)
    qualified = (synd == 0).all(-1)
    return {
        "frame_error": frame_error,
        "bit_errors": err.to(torch.float32).sum(-1),
        "detected_failure": ~qualified,
        "undetected_error": torch.logical_and(qualified, frame_error),
    }
