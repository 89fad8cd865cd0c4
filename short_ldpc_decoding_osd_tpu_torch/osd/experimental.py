"""Batched equivalents of the reference's experimental OSD entry points.

Port of ``short_ldpc_decoding_osd_tpu/osd/experimental.py`` (reference
``DL_Training_serial/ordered_statistics_decoding.py``, statistics and
search flavours beside the production path):

* ``swap_statistics``        — ``stat_pre_osd`` (``:40-59``): histogram of
  GE column-swap counts + the reliability rank of the n_S-th swapped column.
* ``updated_mrb_indices``    — ``stat_pro_osd`` (``:61-84``): the original
  positions forming each frame's MRB after elimination.
* ``combination_block``      — ``combination_mrb`` (``:112-126``).
* ``tailored_pattern``       — (``:160-176``): a TEP block as the cartesian
  sum of per-segment combination blocks.
* ``candidate_matrix``       — every frame's full codeword candidates.
* ``best_estimation_counts`` — ``execute_osd_4`` (``:262-311``): strict
  argmin-candidate success/failure counters.
* ``medium_row_echelon``     — ``medium_gf2elim`` (``:313-345``), host numpy.

The elimination is ``gf2ops.identify_mrb``: the GE kernel's dense load on
the card, the dense plain route on the CPU (JAX's CPU route).  The
discrepancies of ``best_estimation_counts`` take one K5 launch
(``engine._tep_discrepancies``).  The host helpers are copies of the JAX
package's, so the port imports nothing of it.
"""

from __future__ import annotations

from collections import Counter
from itertools import combinations

import numpy as np
import torch

from .._device import full_f32
from ..ops import gf2ops
from ..ops.nms import first_argmin
from .engine import PreparedBatch, _selected_is_label, _tep_discrepancies


def medium_row_echelon(mat: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Row-echelon form over GF(2) with no column exchanges.

    Returns (reduced matrix, positions of dependent columns — columns that
    provided no pivot among the remaining rows)."""
    m = np.array(mat, dtype=np.uint8) & 1
    rows, cols = m.shape
    dependent: list[int] = []
    i = 0
    for j in range(cols):
        if i >= rows:
            break  # all pivots placed; remaining columns are free, not dependent
        pivots = np.nonzero(m[i:, j])[0]
        if pivots.size == 0:
            dependent.append(j)
            continue
        p = i + pivots[0]
        if p != i:
            m[[i, p]] = m[[p, i]]
        flip = np.outer(m[:, j], m[i])
        flip[i] = 0
        m ^= flip.astype(np.uint8)
        i += 1
    return m, dependent


def _eliminate(updated: torch.Tensor, h, k: int) -> dict:
    """``identify_mrb`` of H's columns in ascending-|updated| order."""
    _, h_p = gf2ops.reliability_sort(updated, h)
    return gf2ops.identify_mrb(h_p, k)


def swap_statistics(updated: torch.Tensor, h, k: int,
                    n_s: int = 0) -> tuple[dict, np.ndarray]:
    """Histogram {swap count: frames} of the GE column swaps over a batch,
    and per frame the reliability rank of the ``n_s``-th column pulled into
    the LRB from the nominal MRB side (-1 where fewer than ``n_s + 1`` were
    pulled; reference ``stat_pre_osd``).

    JAX sorts each frame's pulled ranks in a Python loop; here one batched
    sort, with the ranks below ``n - k`` sent to the end, gives the same
    ``initial_index``."""
    info = _eliminate(updated, h, k)
    swap_len = info["swap_len"].cpu().numpy()
    hist = dict(Counter(swap_len.tolist()))
    ranks = info["lrb_ranks"].to(torch.int64)  # (B, n-k)
    nk = ranks.shape[1]
    if n_s >= nk:
        return hist, np.full(swap_len.shape, -1, np.int64)
    n = nk + k  # ranks < n: n marks "not pulled" and sorts last
    pulled = torch.sort(torch.where(ranks >= nk, ranks, n), dim=1).values
    pick = pulled[:, n_s]
    return hist, torch.where(pick < n, pick, -1).cpu().numpy()


def updated_mrb_indices(updated: torch.Tensor, h, k: int) -> np.ndarray:
    """(B, k) int32: the reliability-sorted positions of each frame's MRB
    after elimination (reference ``stat_pro_osd``)."""
    info = _eliminate(updated, h, k)
    return info["index_order"][:, -k:].to(torch.int32).cpu().numpy()


def combination_block(k: int, start: int, end: int, level: int) -> np.ndarray:
    """0/1 int8 matrix of all ``level``-combinations inside [start, end) of
    a k-wide MRB (reference ``combination_mrb``); level 0 -> one zero row."""
    if level == 0:
        return np.zeros((1, k), np.int8)
    rows = []
    for combo in combinations(range(start, end), level):
        row = np.zeros(k, np.int8)
        row[list(combo)] = 1
        rows.append(row)
    return np.stack(rows)


def tailored_pattern(direction: list[int],
                     segment_blocks: list[list[np.ndarray]]) -> np.ndarray:
    """The TEP block of one order pattern: the cartesian sum of
    ``segment_blocks[s][direction[s]]`` over segments, int8 (reference
    ``tailored_pattern``)."""
    block = segment_blocks[0][direction[0]]
    for s in range(1, len(direction)):
        nxt = segment_blocks[s][direction[s]]
        block = (block[:, None, :] + nxt[None, :, :]).reshape(-1, block.shape[1])
    return block.astype(np.int8)


@full_f32()
def candidate_matrix(prep: PreparedBatch, teps: torch.Tensor,
                     k: int) -> torch.Tensor:
    """(B, N, n) float32 0/1 codeword candidates of every frame and TEP:
    LRB part ``mod2(M @ (tep xor mrb0))``, MRB part ``tep xor mrb0`` (the
    batched core of ``execute_osd2`` / stage-3 ``execute_osd``)."""
    base_mrb = prep.hard_updated[:, -k:].to(torch.float32)  # (B, k)
    tep_f = teps.to(torch.float32)  # (N, k)
    mrb_c = (base_mrb[:, None, :] - tep_f[None, :, :]).abs()  # (B, N, k)
    lrb_c = gf2ops.mod2_matmul(prep.m_matrix, mrb_c.transpose(1, 2))
    return torch.cat([lrb_c.transpose(1, 2).to(torch.float32), mrb_c], 2)


def best_estimation_counts(prep: PreparedBatch, teps: torch.Tensor,
                           k: int) -> tuple[int, int]:
    """(correct, failed): frames whose argmin-discrepancy candidate (the
    weighted Hamming distance to the original-channel hard decision; first
    index on ties) is, or is not, the transmitted word (reference
    ``execute_osd_4``).

    The discrepancies are one K5 launch plus IEEE-f32 terms.  JAX takes its
    weighted sums at default precision, which is IEEE f32 on the CPU: the
    CPU's semantics are the ones held.  Only the argmin's candidate is
    rebuilt, not the (B, N, n) tensor."""
    t_flat = teps.to(torch.int8).contiguous()
    best = first_argmin(_tep_discrepancies(prep, t_flat, k), 1)
    correct = int(_selected_is_label(prep, t_flat[best], k).sum())
    return correct, prep.order_labels.shape[0] - correct
