"""The least time of NMS-r's decodes on one H100, from the call's shapes,
with ``roofline``'s rates and ``bound_s``.

NMS-r's check update gives each edge the sorted magnitudes of its row's
other dc-1 edges through ``(x @ w1) @ w2``.  The count is the least work
that function needs, whatever implements it, so that no implementation
can read above its bound:

* the two layers have no activation between them, so they are one dot
  product of dc-1 weights, ``w1 @ w2``;
* every edge's leave-one-out list is its row's sorted list less that
  edge's entry: an edge at sorted position r weighs the entries before r
  by the first r weights and those after it by the weights shifted down
  by one.  So a row needs one sort, a sorting network of dc magnitudes
  (19 compare-exchanges for 8, 2 instructions each), and the prefix and
  suffix sums of its weighted sorted entries (2 (dc - 1) FMAs);
* an edge then needs the five operations of ``roofline.edge_ops`` that
  are not the min-sum tournament (column add, ``vc = total - cv``,
  ``|vc|``, the sign parity, the sign apply) and two more: the select of
  its sorted position and the add of its prefix and suffix terms;
* a check 2 instructions and a variable 1, a frame-iteration, and each
  closing column sum 1 an edge and 1 a variable, as ``edge_ops`` counts.

On CCSDS (128,64) (64 rows of degree 8, 512 edges, 128 variables) that
is 64 (38 + 14) + 512 x 7 + 2 x 64 + 128 = 7,168 f32 instructions a
frame-iteration, against NMS-1's 4,352.
"""

from __future__ import annotations

import numpy as np

from gpubench import roofline

# compare-exchanges of the smallest known sorting networks, by input count
SORT_NETWORK = {1: 0, 2: 1, 3: 3, 4: 5, 5: 9, 6: 12, 7: 16, 8: 19, 9: 25,
                10: 29, 11: 35, 12: 39, 13: 45, 14: 51, 15: 56, 16: 60}
# instructions a compare-exchange (a min and a max)
EXCHANGE = 2
# instructions an edge beyond the row's sort and sums
EDGE = 5 + 2


def frame_iteration_ops(h) -> int:
    """f32 instructions of one NMS-r iteration on one frame of ``h``, a
    parity matrix of a regular check degree."""
    h = np.asarray(h)
    m, n = h.shape
    degrees = h.sum(1)
    dc = int(degrees[0])
    if (degrees != dc).any():
        raise ValueError("NMS-r needs a regular check degree")
    row = EXCHANGE * SORT_NETWORK[dc] + 2 * (dc - 1)
    return m * row + EDGE * m * dc + 2 * m + n


def decode_ops(h, frame_iters: float, closings: float) -> float:
    """f32 instructions of ``frame_iters`` frame-iterations and
    ``closings`` closing column sums."""
    edges = int(np.asarray(h).sum())
    return frame_iters * frame_iteration_ops(h) + closings * (edges + h.shape[1])


def capture_bound_s(h, batch: int, iters: int, cap: int) -> float:
    """The capture step: ``iters`` iterations and a closing sum of
    ``batch`` frames against the captured rows (f32 LLR and int32 word)
    and the five int64 counters out."""
    n = h.shape[1]
    ops = decode_ops(h, batch * iters, batch)
    return roofline.bound_s(8 * cap * n + 8 * 5, ops / roofline.F32_INSTR)


def redecode_bound_s(h, rows: int, iters: int) -> float:
    """The re-decode trajectory of ``rows`` captured rows: their f32 LLR
    in and ``iters + 1`` f32 slots out, against ``iters`` iterations and
    a closing sum of each row."""
    n = h.shape[1]
    ops = decode_ops(h, rows * iters, rows)
    return roofline.bound_s(4 * rows * n * (iters + 2), ops / roofline.F32_INSTR)
