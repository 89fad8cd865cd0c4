"""Host-side GF(2) linear algebra (numpy, set-up time only).

A copy of ``short_ldpc_decoding_osd_tpu/codes/gf2.py``: the port keeps its
own so that it never imports the JAX package.

Single authoritative implementation of the row-echelon reduction that the
reference copy-pastes ~10x (e.g. ``Training_data_gen_128/fill_matrix_info.py:6-41``,
``DL_OSD_Testing_serial/ordered_statistics_decoding.py:222-257``).  The
*semantics* are kept identical because downstream most-reliable-basis (MRB)
selection depends on the exact column-swap bookkeeping:

* walk a pivot cursor diagonally (i, j);
* if column j has a 1 in rows i.., pivot on the first such row (row swap);
* else, if row i is all-zero from j on, drop the redundant row;
* else swap in the first column j' > j with ``M[i, j'] == 1`` and record
  the pair ``(j, j')``;
* eliminate above *and* below the pivot (full reduced row echelon form).

These routines run on the host at set-up time (building G from H,
constructing static TEP tables).  The batched per-frame elimination used
inside decoding lives in ``ops/gf2ops.py`` as fixed-shape tensor code.
"""

from __future__ import annotations

import numpy as np


def row_reduce(mat: np.ndarray) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Reduce ``mat`` (0/1 ints) to reduced row-echelon form over GF(2).

    Returns ``(reduced, col_swaps)`` where ``col_swaps`` is the ordered list
    of recorded column exchanges ``(dst, src)``.  All-zero rows that appear
    during the reduction are deleted, so the output may have fewer rows.

    Mirrors the reference's ``gf2elim``/``full_gf2elim`` semantics
    (``fill_matrix_info.py:6-41``) — required for MRB-selection parity.
    """
    m_rows, n_cols = mat.shape
    work = mat.astype(np.uint8).copy()
    col_swaps: list[tuple[int, int]] = []
    i = 0
    j = 0
    while i < m_rows and j < n_cols:
        col_tail = work[i:, j]
        if col_tail.any():
            pivot = int(np.argmax(col_tail)) + i
            if pivot != i:
                work[[i, pivot]] = work[[pivot, i]]
        else:
            row_tail = work[i, j:]
            if not row_tail.any():
                # redundant all-zero row: drop it and retry the same (i, j)
                work = np.delete(work, i, axis=0)
                m_rows -= 1
                continue
            src = int(np.argmax(row_tail)) + j
            work[:, [j, src]] = work[:, [src, j]]
            col_swaps.append((j, src))
        # eliminate the j-th column everywhere except the pivot row
        col = work[:, j].copy()
        col[i] = 0
        work[:, j:] ^= np.outer(col, work[i, j:])
        i += 1
        j += 1
    return work, col_swaps


def apply_swaps_to_index(n_cols: int, col_swaps: list[tuple[int, int]]) -> np.ndarray:
    """Column order implied by a swap record: ``order[pos] = original column``.

    Mirrors the index-order update loop of ``identify_mrb``
    (``DL_OSD_Testing_serial/ordered_statistics_decoding.py:59-63``).
    """
    order = np.arange(n_cols)
    for dst, src in col_swaps:
        order[dst], order[src] = order[src], order[dst]
    return order


def generator_from_parity(parity: np.ndarray) -> np.ndarray:
    """Systematic generator matrix G (k x n) for parity-check matrix H (m x n).

    H is reduced to ``[I | H2]`` (with recorded column swaps), G is formed as
    ``[H2^T | I]`` and the swaps are undone in reverse, so that
    ``H @ G.T == 0 (mod 2)``.  Reference: ``fill_matrix_info.py:43-68``.
    """
    reduced, col_swaps = row_reduce(parity)
    m_rows, n_cols = reduced.shape
    h2 = reduced[:, m_rows:]
    gen = np.concatenate(
        [h2.T, np.eye(n_cols - m_rows, dtype=np.uint8)], axis=1
    ).astype(np.uint8)
    for dst, src in reversed(col_swaps):
        gen[:, [dst, src]] = gen[:, [src, dst]]
    syndrome = parity.astype(np.int64) @ gen.T.astype(np.int64) % 2
    if syndrome.any():
        raise ValueError("generator construction failed: H @ G.T != 0 (mod 2)")
    return gen


def rank(mat: np.ndarray) -> int:
    """GF(2) rank (rows surviving full reduction)."""
    reduced, _ = row_reduce(mat)
    return int((reduced.any(axis=1)).sum())


def row_basis(mat: np.ndarray) -> np.ndarray:
    """Maximal linearly independent subset of ``mat``'s rows (original rows,
    in their original order).

    Used to hand rank-deficient parity matrices (e.g. the packaged array
    codes, whose H carries redundant rows like the reference's
    ``ArrayCode_*.alist`` assets) to the fixed-shape OSD elimination.

    CONSCIOUS DIVERGENCE from the reference: the reference's per-frame
    ``gf2elim`` keeps redundant rows and deletes them as they turn zero
    mid-elimination (``fill_matrix_info.py:6-41``).  When a pivot column has
    no 1 below the cursor, the column swapped in is read from the *current
    physical row*, so zombie (not-yet-deleted zero) rows can shift which
    column gets recorded — reducing the basis can therefore record a
    different (equally valid) swap in such degenerate steps.  The row space,
    the reliability ordering, and the "most reliable independent basis"
    property of the resulting MRB are identical; the reference pipeline only
    ever runs the full-rank CCSDS code, where the two are bit-identical.
    """
    mat = np.asarray(mat, dtype=np.uint8)
    pivots: dict[int, np.ndarray] = {}  # pivot column -> reduced row
    keep: list[int] = []
    for i, row in enumerate(mat):
        work = row.copy()
        while True:
            nz = np.flatnonzero(work)
            if nz.size == 0:
                break  # dependent row
            p = int(nz[0])
            if p not in pivots:
                pivots[p] = work
                keep.append(i)
                break
            work = work ^ pivots[p]
    return mat[keep]
