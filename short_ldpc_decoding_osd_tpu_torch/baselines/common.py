"""Shared G-domain preparation for the FS/PB/conventional baselines.

Port of ``short_ldpc_decoding_osd_tpu/baselines/common.py``.  Unlike the
DL-OSD stages (H-based, ascending reliability), the baselines sort |LLR|
*descending*, permute the generator matrix G, and reduce G to a systematic
``[I | P]`` with both the MRB and LRB position groups re-sorted ascending
by reliability rank (``FS_OSD/fs_testing.py:270-322``).

Two hand kernels carry the work on the card:

* the GF(2) elimination of the permuted G is the GE kernel's dense load
  (``ops.gf2_bitpack.reduce_dense``, ``csrc/gf2_ge.cu``); on the CPU it is
  the dense route ``ops.gf2ops.batched_row_reduce``, JAX's CPU route.  The
  two agree only on full-row-rank input, so :func:`prepare_g_domain`
  raises on a G that is not;
* the parity term of every TEP distance, ``sum_l u_l * mod2(e @ P)``, is
  kernel K5 (``ops.osd_disc.lterm`` with M = P^T), one launch per weight
  vector over every TEP; on the CPU its plain twin, in fixed blocks of
  ``CPU_TEP_BLOCK`` TEPs (the CPU's matmul may sum a block of another
  width in another order, so the block is not a parameter).  The
  baselines keep JAX's ``chunk=`` argument for API parity; it changes
  nothing.

The MRB term ``u_m @ T^T`` and every other contraction run in IEEE f32
(``_device.full_f32``): JAX runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

from .._device import full_f32, resolve_device
from ..codes import tables
from ..ops import gf2_bitpack, gf2ops, osd_disc

CPU_TEP_BLOCK = 2048  # TEPs a block of the CPU twin of the parity term


def check_full_row_rank(g) -> None:
    """Raise ``ValueError`` unless the (k, n) G has GF(2) rank k (read once
    per matrix, ``codes.tables``)."""
    rows, cols = g.shape
    if tables.rank(g) != rows:
        raise ValueError(
            f"prepare_g_domain: G ({rows} x {cols}) is not of full "
            "row rank; the GE kernel and the dense route differ on such input")


def as_batch(inputs, labels, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) inputs as f32 and labels, numpy or tensors, on ``device``
    (raises for CUDA without a card)."""
    dev = resolve_device(device)
    return (torch.as_tensor(inputs, dtype=torch.float32, device=dev),
            torch.as_tensor(labels, device=dev))


def prepare_g_domain(inputs: torch.Tensor, labels: torch.Tensor, g,
                     k: int) -> dict:
    """Batched G-domain OSD preprocessing.

    Args:
      inputs: (B, n) f32 channel LLR proxies.
      labels: (B, n) transmitted bits.
      g: (k, n) generator matrix (numpy or tensor) of full row rank.

    Returns a dict with ``inputs`` (B, n) and ``labels`` (B, n) int8,
    permuted so positions 0..k-1 are the MRB (descending-reliability ranks
    re-sorted ascending) and k..n-1 the LRB, and ``p_matrix`` (B, k, n-k)
    int8, the parity part of each frame's systematic generator ``[I | P]``.
    """
    check_full_row_rank(g)
    n = inputs.shape[1]
    order = torch.sort(-inputs.abs(), dim=-1, stable=True).indices  # descending
    g_sorted = gf2ops.permute_columns(order, g)  # (B, k, n)
    if inputs.device.type == "cuda":
        tail, col_order = gf2_bitpack.reduce_dense(g_sorted, n - k)
        col_order = col_order.long()
    else:
        reduced, col_order = gf2ops.batched_row_reduce(g_sorted)
        tail = reduced[:, :, k:]
    mrb_ranks, lrb_ranks = col_order[:, :k], col_order[:, k:]
    # ranks are a permutation's values: distinct, so every sort is exact
    mrb_sorted, ms = torch.sort(mrb_ranks, dim=1)
    lrb_sorted, ls = torch.sort(lrb_ranks, dim=1)
    # P rows follow the MRB re-sort (row i of [I|P] owns pivot column i),
    # P columns follow the LRB re-sort
    p = torch.gather(tail, 1, ms[:, :, None].expand(-1, -1, n - k))
    p = torch.gather(p, 2, ls[:, None, :].expand(-1, k, -1))
    full_perm = torch.gather(order, 1, torch.cat([mrb_sorted, lrb_sorted], 1))
    return {
        "inputs": torch.gather(inputs, 1, full_perm),
        "labels": torch.gather(labels.to(torch.int8), 1, full_perm),
        "p_matrix": p.to(torch.int8).contiguous(),
    }


def candidate_distance_terms(prep: dict, k: int) -> dict:
    """Affine decomposition of weighted/unweighted candidate distances.

    For TEP e (over the MRB), the candidate codeword is
    ``[mrb0 ^ e | (mrb0 ^ e) @ P]``; with hard decisions hd and magnitudes w
    the distances decompose as (x^y = x+y-2xy):

      wd(e) = c_w + uw_m . e + uw_l . mod2(e @ P)
      hd(e) = c_h + uh_m . e + uh_l . mod2(e @ P)

    Returns the constants/vectors plus base quantities."""
    inputs = prep["inputs"]
    hard = (inputs <= 0).to(torch.float32)
    mag = inputs.abs()
    mrb0 = hard[:, :k]
    lrb0 = gf2ops.mod2_matmul(mrb0[:, None, :], prep["p_matrix"])[:, 0]
    lrb0 = lrb0.to(torch.float32)
    # distance of the zero-TEP candidate on LRB: d0 = lrb0 ^ hard_lrb
    d0 = lrb0 + hard[:, k:] - 2.0 * lrb0 * hard[:, k:]

    def terms(weight):
        w_m, w_l = weight[:, :k], weight[:, k:]
        c = (w_l * d0).sum(1)  # MRB part of zero-TEP distance is 0
        return c, w_m.contiguous(), (w_l * (1.0 - 2.0 * d0)).contiguous()

    c_w, uw_m, uw_l = terms(mag)
    c_h, uh_m, uh_l = terms(torch.ones_like(mag))
    return {"hard": hard, "mag": mag, "mrb0": mrb0, "lrb0": lrb0, "d0": d0,
            "c_w": c_w, "uw_m": uw_m, "uw_l": uw_l,
            "c_h": c_h, "uh_m": uh_m, "uh_l": uh_l}


def parity_term(p_matrix: torch.Tensor, u_l: torch.Tensor,
                teps: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 ``sum_l u_l[b, l] * mod2(teps @ P[b])[n, l]``: kernel K5
    with M = P^T on CUDA, in one launch; its plain twin on the CPU,
    ``CPU_TEP_BLOCK`` TEPs at a time (a (B, n-k, block) parity tensor)."""
    m_mat = p_matrix.transpose(1, 2).to(torch.int8).contiguous()
    u_l = u_l.to(torch.float32).contiguous()
    teps = teps.to(torch.int8).contiguous()
    if p_matrix.device.type != "cpu":
        return osd_disc.lterm(m_mat, u_l, teps)
    return torch.cat([osd_disc.lterm(m_mat, u_l, teps[s:s + CPU_TEP_BLOCK])
                      for s in range(0, max(teps.shape[0], 1), CPU_TEP_BLOCK)],
                     1)


@full_f32()
def mrb_term(u_m: torch.Tensor, teps: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 ``u_m @ teps^T`` in IEEE f32."""
    return u_m @ teps.to(torch.float32).T


def tep_distances(terms: dict, teps: torch.Tensor, p_matrix: torch.Tensor,
                  with_hd: bool = True):
    """(weighted, unweighted) distances for a TEP matrix.

    teps: (N, k) 0/1 on the batch's device; p_matrix: (B, k, n-k).  JAX's
    ``tep_distances`` also returns the (B, N, n-k) parity tensor; K5 never
    writes it, so a caller that needs another weighting of it calls
    :func:`parity_term` with that weight.  ``with_hd=False`` skips the
    unweighted distance (and its K5 launch) and returns None for it."""
    wd = (terms["c_w"][:, None] + mrb_term(terms["uw_m"], teps)
          + parity_term(p_matrix, terms["uw_l"], teps))
    if not with_hd:
        return wd, None
    hd = (terms["c_h"][:, None] + mrb_term(terms["uh_m"], teps)
          + parity_term(p_matrix, terms["uh_l"], teps))
    return wd, hd


def reencode_success(terms: dict, prep: dict, tep_sel: torch.Tensor) -> torch.Tensor:
    """Per-frame success of the candidate ``[mrb0 ^ e | (mrb0 ^ e) @ P]``
    for the chosen (B, k) 0/1 f32 TEPs: equal to the label everywhere."""
    mrb_c = (terms["mrb0"] - tep_sel).abs()  # xor with 0/1 floats
    a = gf2ops.mod2_matmul(tep_sel[:, None, :], prep["p_matrix"])[:, 0]
    lrb_c = (terms["lrb0"] - a.to(torch.float32)).abs()
    cand = torch.cat([mrb_c, lrb_c], 1)
    return (cand == prep["labels"].to(torch.float32)).all(1)
