"""Batched, fixed-shape GF(2) Gaussian elimination for OSD, plain PyTorch.

Port of ``short_ldpc_decoding_osd_tpu/ops/gf2ops.py`` (there XLA, not
Pallas).  The reference runs a per-frame Python loop with dynamic row
deletion and column swaps (``full_gf2elim``,
``DL_OSD_Testing_serial/ordered_statistics_decoding.py:222-257``).  Here the
elimination is exactly ``m`` fixed-shape steps over the batch with the same
pivot/column-swap semantics, at step t:

  1. if column t has a 1 in rows t.., pivot on the FIRST such row (row swap);
  2. else swap in the FIRST column c > t with ``M[t, c] == 1`` (recorded in
     the column-order vector, the reference's ``index_order`` bookkeeping);
  3. XOR-eliminate the pivot column everywhere else (full RREF).

"First" is a first-occurrence rule (``jnp.argmax`` over 0/1 in JAX).  A CUDA
``argmax`` does not promise which of equal maxima it returns, so the port
computes the first index explicitly (``nms.first_index``).

Two routes, as in JAX.  The dense route (:func:`batched_row_reduce`, plain
PyTorch) is JAX's CPU route; the bit-packed route (``ops/gf2_bitpack.py``,
the CUDA kernel ``csrc/gf2_ge.cu`` on the card) is JAX's TPU route.
``use_packed=None`` takes the packed route on a CUDA tensor and the dense
route on the CPU; ``True`` runs the packed plain twin on the CPU and the
kernel on CUDA; ``False`` is the dense route on either.  The two agree bit
for bit on full-row-rank matrices (every packaged ``h_osd``); on a
rank-deficient one a step with no pivot and no swap column differs (the
dense route swaps column t with column 0, the packed one leaves the
columns), so each route is held to its own JAX twin.
"""

from __future__ import annotations

import torch

from ..codes import tables
from . import gf2_bitpack
from .nms import first_index


def batched_row_reduce(h_batch: torch.Tensor):
    """Reduce each (m, n) 0/1 matrix of the batch to RREF with column swaps.

    Returns ``reduced`` (B, m, n) int8 (leading m x m block = identity for a
    full-row-rank input) and ``col_order`` (B, n) int64, the original column
    now at each position."""
    mat = h_batch.to(torch.int8).clone()
    batch, m, n = mat.shape
    dev = mat.device
    bidx = torch.arange(batch, device=dev)
    row_ids = torch.arange(m, device=dev)
    col_ids = torch.arange(n, device=dev)
    col_order = col_ids.expand(batch, n).clone()
    for t in range(m):
        col_masked = (mat[:, :, t] > 0) & (row_ids >= t)
        has_pivot = col_masked.any(1)
        pivot_row = first_index(col_masked, 1)
        row_masked = (mat[:, t, :] > 0) & (col_ids > t)
        swap_col = torch.where(has_pivot, t, first_index(row_masked, 1))

        # columns t <-> swap_col (a no-op where swap_col == t)
        t_vals = mat[:, :, t].clone()
        mat[:, :, t] = mat[bidx, :, swap_col]
        mat[bidx, :, swap_col] = t_vals
        ord_t = col_order[:, t].clone()
        col_order[:, t] = col_order[bidx, swap_col]
        col_order[bidx, swap_col] = ord_t

        # rows t <-> pivot_row
        pr = torch.where(has_pivot, pivot_row, t)
        t_row = mat[:, t, :].clone()
        mat[:, t, :] = mat[bidx, pr, :]
        mat[bidx, pr, :] = t_row

        # eliminate column t everywhere except row t; columns < t of the
        # pivot row are already zero, so only columns t.. change
        pivot = mat[:, t, t:]
        col = mat[:, :, t].clone()
        col[:, t] = 0
        mat[:, :, t:] ^= col[:, :, None] & pivot[:, None, :]
    return mat, col_order


def permute_columns(perm: torch.Tensor, h) -> torch.Tensor:
    """(B, n) permutation x static (m, n) H -> (B, m, n) column-permuted H:
    ``out[b, :, pos] = h[:, perm[b, pos]]`` (an exact gather)."""
    return tables.int8(h, perm.device).T[perm].transpose(1, 2).contiguous()


def reliability_sort(inputs: torch.Tensor, h):
    """Positions sorted by ascending |input| (stable) and the correspondingly
    column-permuted H (``check_matrix_reorder``,
    ``ordered_statistics_decoding.py:30-41``)."""
    perm = torch.sort(inputs.abs(), dim=-1, stable=True).indices
    return perm, permute_columns(perm, h)


def _mrb_post(reduced_tail: torch.Tensor, col_order: torch.Tensor, n: int,
              k: int) -> dict:
    """MRB re-sort (ascending reliability rank) + M matrix."""
    mrb_cols = col_order[:, -k:]
    # ranks are a permutation's values: distinct, so the sort is exact
    mrb_sorted, sort_idx = torch.sort(mrb_cols, dim=1)
    index_order = torch.cat([col_order[:, : n - k], mrb_sorted], 1)
    m_rows = reduced_tail.shape[1]
    m_matrix = torch.gather(
        reduced_tail, 2, sort_idx[:, None, :].expand(-1, m_rows, -1)
    ).to(torch.int8)
    swap_len = (mrb_cols < n - k).to(torch.int32).sum(1)
    return {
        "m_matrix": m_matrix,
        "index_order": index_order,
        "swap_len": swap_len,
        "lrb_ranks": col_order[:, : n - k],
    }


def _packed(use_packed: bool | None, device: torch.device) -> bool:
    return device.type == "cuda" if use_packed is None else use_packed


def identify_mrb(h_batch: torch.Tensor, k: int,
                 use_packed: bool | None = None) -> dict:
    """MRB identification on reliability-permuted parity matrices
    (``identify_mrb``, ``ordered_statistics_decoding.py:43-80``).

    Returns ``m_matrix`` (B, m, k) int8 (MRB -> LRB re-encode map, columns
    by ascending rank), ``index_order`` (B, n) (first n-k = LRB, last k = MRB
    ascending), ``swap_len`` (B,) and ``lrb_ranks`` (B, n-k).  The route
    follows ``use_packed`` (module docstring)."""
    n = h_batch.shape[2]
    if _packed(use_packed, h_batch.device):
        tail, col_order = gf2_bitpack.reduce_dense(h_batch, k)
        return _mrb_post(tail, col_order.long(), n, k)
    reduced, col_order = batched_row_reduce(h_batch)
    return _mrb_post(reduced[:, :, n - k:], col_order, n, k)


def identify_mrb_from_perm(perm: torch.Tensor, h, k: int,
                           use_packed: bool | None = None) -> dict:
    """:func:`identify_mrb` of ``permute_columns(perm, h)``.  The packed
    route builds each frame's packed rows from the static ``h`` (packed
    once per device) and ``perm``, and unpacks only the k tail columns; the
    dense route materializes the (B, m, n) permuted matrix."""
    if _packed(use_packed, perm.device):
        tail, col_order = gf2_bitpack.reduce_from_perm(perm, h, k)
        return _mrb_post(tail, col_order.long(), perm.shape[1], k)
    return identify_mrb(permute_columns(perm, h), k, use_packed=False)


def lrb_swap_indicator(lrb_ranks: torch.Tensor, jump_point: int) -> torch.Tensor:
    """Indicator of LRB slots whose reliability rank >= jump_point
    (``ordered_statistics_decoding.py:75-76``)."""
    return (lrb_ranks >= jump_point).to(torch.int8)


def mod2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2) matmul via an integer-exact f32 matmul + parity."""
    prods = a.to(torch.float32) @ b.to(torch.float32)
    return (prods - 2.0 * torch.floor(prods * 0.5)).to(torch.int8)
