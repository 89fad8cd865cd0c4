"""Host-side code tables of the reference: the generator matrix, the edge
order of the decoders and the TEP blocks of a decoding path.

Each is a frozen copy of a rule that fixes *which* frames and TEPs the
system works on, so the reference derives exactly the same ones:

* G from H by the reference recipe's row reduction (pivot on the first row
  with a 1, else swap in the first column with a 1 in the pivot row, full
  RREF, swaps undone in reverse): ``fill_matrix_info.py:43-68``;
* the edge order: slot j of check c is its j-th variable in ascending
  order, and a variable's edges are summed in ascending check order;
* the 6-way MRB split ``[1] + (k-1 split prop. to 1:2:3:4:5)`` and the
  cartesian TEP blocks of each order pattern, concatenated densely and
  padded to chunks of 256 (``globalmap.py:66-85``,
  ``ordered_statistics_decoding.py:81-98``).
"""

from __future__ import annotations

import itertools

import numpy as np


def _row_reduce(mat: np.ndarray):
    work = mat.astype(np.uint8).copy()
    m_rows, n_cols = work.shape
    swaps = []
    i = j = 0
    while i < m_rows and j < n_cols:
        tail = work[i:, j]
        if tail.any():
            pivot = int(np.argmax(tail)) + i
            if pivot != i:
                work[[i, pivot]] = work[[pivot, i]]
        else:
            row = work[i, j:]
            if not row.any():
                work = np.delete(work, i, axis=0)
                m_rows -= 1
                continue
            src = int(np.argmax(row)) + j
            work[:, [j, src]] = work[:, [src, j]]
            swaps.append((j, src))
        col = work[:, j].copy()
        col[i] = 0
        work[:, j:] ^= np.outer(col, work[i, j:])
        i += 1
        j += 1
    return work, swaps


def generator(h: np.ndarray) -> np.ndarray:
    """(k, n) uint8 systematic-derived generator of the parity matrix."""
    reduced, swaps = _row_reduce(h)
    m_rows, n_cols = reduced.shape
    gen = np.concatenate([reduced[:, m_rows:].T,
                          np.eye(n_cols - m_rows, dtype=np.uint8)], axis=1)
    for dst, src in reversed(swaps):
        gen[:, [dst, src]] = gen[:, [src, dst]]
    if (h.astype(np.int64) @ gen.T.astype(np.int64) % 2).any():
        raise ValueError("H @ G^T != 0 (mod 2)")
    return gen.astype(np.uint8)


def edges(h: np.ndarray):
    """``edge_col`` (dc, m): variable of slot j of check c (-1 padding);
    ``var_edges`` (dv, n): edge ids ``j * m + c`` of variable v in
    ascending check order (-1 padding)."""
    m, n = h.shape
    dc = int(h.sum(1).max())
    dv = int(h.sum(0).max())
    edge_col = np.full((dc, m), -1, np.int64)
    for c in range(m):
        cols = np.flatnonzero(h[c])
        edge_col[: len(cols), c] = cols
    var_edges = np.full((dv, n), -1, np.int64)
    for v in range(n):
        checks = np.flatnonzero(h[:, v])
        ids = [int(np.flatnonzero(edge_col[:, c] == v)[0]) * m + c for c in checks]
        var_edges[: len(ids), v] = ids
    return edge_col, var_edges


def _segment_ranges(k: int, num_segments: int):
    basic = list(range(1, num_segments))
    sizes = [int((k - 1) / sum(basic) * b) for b in basic]
    sizes[-1] += (k - 1) - sum(sizes)
    bounds = np.concatenate([[0], np.cumsum([1] + sizes)])
    return [range(int(bounds[i]), int(bounds[i + 1]))
            for i in range(num_segments)]


def _block(pattern, ranges, k: int) -> np.ndarray:
    per_segment = [[()] if int(w) == 0 else list(itertools.combinations(r, int(w)))
                   for r, w in zip(ranges, pattern)]
    rows = []
    for combo in itertools.product(*per_segment):
        row = np.zeros(k, np.int8)
        for group in combo:
            row[list(group)] = 1
        rows.append(row)
    return np.stack(rows) if rows else np.zeros((0, k), np.int8)


def tep_table(path, k: int, num_segments: int = 6, chunk: int = 256):
    """The path's TEPs concatenated densely and padded with zero rows to a
    multiple of ``chunk``: (flat (N, k) int8, valid (N,) bool, bounds of
    each block as (start, stop)).  The padded count N is what the system
    computes discrepancies for."""
    ranges = _segment_ranges(k, num_segments)
    blocks = [_block(p, ranges, k) for p in path]
    sizes = [len(b) for b in blocks]
    total = int(sum(sizes))
    padded = -(-total // chunk) * chunk
    flat = np.zeros((padded, k), np.int8)
    flat[:total] = np.concatenate(blocks)
    valid = np.zeros(padded, bool)
    valid[:total] = True
    acc = np.concatenate([[0], np.cumsum(sizes)])
    bounds = [(int(acc[i]), int(acc[i + 1])) for i in range(len(blocks))]
    return flat, valid, bounds

