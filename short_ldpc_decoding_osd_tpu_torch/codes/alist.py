"""alist parity-check matrix reader/writer (MacKay format).

The reference parses alists inline in its ``Code.load_code``
(``Training_data_gen_128/fill_matrix_info.py:69-121``); here parsing is a
standalone pure function so the ``Code`` object stays a thin dataclass.

alist layout::

    n m
    max_var_degree max_chk_degree
    <per-variable degrees>
    <per-check degrees>
    n lines: 1-based check indices per variable (0-padded allowed)
    m lines: 1-based variable indices per check (0-padded allowed)
"""

from __future__ import annotations

import numpy as np


def parse_alist(text: str) -> np.ndarray:
    """Parse alist text into a dense 0/1 parity-check matrix H of shape (m, n)."""
    lines = [ln.split() for ln in text.strip().splitlines() if ln.strip()]
    n, m = int(lines[0][0]), int(lines[0][1])
    # lines[1] = max degrees, lines[2]/lines[3] = degree lists (unused here)
    h = np.zeros((m, n), dtype=np.uint8)
    var_rows = lines[4 : 4 + n]
    for col, row_ids in enumerate(var_rows):
        for tok in row_ids:
            idx = int(tok)
            if idx > 0:
                h[idx - 1, col] = 1
    return h


def load_alist(path: str) -> np.ndarray:
    with open(path, "rt") as fh:
        return parse_alist(fh.read())


def dump_alist(h: np.ndarray) -> str:
    """Serialize a dense 0/1 parity-check matrix to alist text."""
    h = np.asarray(h, dtype=np.uint8)
    m, n = h.shape
    var_deg = h.sum(axis=0).astype(int)
    chk_deg = h.sum(axis=1).astype(int)
    out = [
        f"{n} {m}",
        f"{var_deg.max()} {chk_deg.max()}",
        " ".join(str(d) for d in var_deg),
        " ".join(str(d) for d in chk_deg),
    ]
    for col in range(n):
        rows = np.flatnonzero(h[:, col]) + 1
        out.append(" ".join(str(r) for r in rows) if rows.size else "0")
    for row in range(m):
        cols = np.flatnonzero(h[row]) + 1
        out.append(" ".join(str(c) for c in cols) if cols.size else "0")
    return "\n".join(out) + "\n"


def save_alist(path: str, h: np.ndarray) -> None:
    with open(path, "wt") as fh:
        fh.write(dump_alist(h))
