"""ENMS: NMS-1, one trained check weight, run on the extended parity
matrix (the reference's ``Code.extending_check_matrix``,
``Training_data_gen_128/fill_matrix_info.py:131-150``): H followed by the
sum of every pair of its rows ``i < j``, in that order, kept where the
sum's weight is at most ``2 * max check degree - 4``.  The extra rows are
sums of H's rows, so a word's syndrome on the extended matrix is zero
exactly when it is on H; they are more checks for the decoder, not more
constraints on the code.

The decode is ``decode.decode`` over the extended matrix's
``decode.Tables`` (slot j of a check its j-th variable in ascending
order, each variable's messages summed in ascending check order, as
``codes.edges`` orders them), built once a reference and kept in it.  Its
numbers are NMS-1's (``variants/NMS-1.py``) on those tables:
``capture_mismatch``, ``redecode_mismatch`` and the fused step's
counters, each exact.
"""

from __future__ import annotations

import numpy as np

from ...core import decoder
from .. import codes, decode

NMS1 = decoder("NMS-1")


def extend(h) -> np.ndarray:
    """(m + extra, n) uint8: ``h`` and the pairwise sums of its rows that
    the reference keeps."""
    h = np.asarray(h).astype(np.uint8)
    cap = 2 * int(h.sum(axis=1).max()) - 4
    parts = [h]
    for i in range(h.shape[0] - 1):
        summed = h[i + 1:] ^ h[i]
        parts.append(summed[summed.sum(axis=1) <= cap])
    return np.concatenate(parts)


def tables(ref) -> decode.Tables:
    """The extended matrix's edge tables on the reference's device, built
    at the first call and kept in ``ref``."""
    if "enms_tables" not in ref:
        base = ref["tables"]
        h = extend(base.h.cpu().numpy())
        ref["enms_tables"] = decode.Tables(h, *codes.edges(h), base.h.device)
    return ref["enms_tables"]


def _extended(ref) -> dict:
    """``ref`` with the extended matrix's tables in H's place."""
    return dict(ref, tables=tables(ref))


def weights(nms_params: dict) -> tuple:
    """(w_vc, w_chk, w_marg) of the run's ``nms_params.pkl``, as NMS-1's."""
    return NMS1.weights(nms_params)


def soft_outputs(llr, ref, iters: int, slots, round_fn=None) -> dict:
    """{slot: (B, n) f32} soft outputs of ``llr`` on the extended matrix
    after each iteration in ``slots``."""
    return NMS1.soft_outputs(llr, _extended(ref), iters, slots, round_fn)


def capture_numbers(ref, cell, index: int, counters, count, llr, labels) -> dict:
    """NMS-1's capture check on the extended matrix."""
    return NMS1.capture_numbers(_extended(ref), cell, index, counters, count,
                                llr, labels)


def redecode_numbers(ref, cell, llr, labels, traj, detected) -> dict:
    """NMS-1's re-decode check on the extended matrix."""
    return NMS1.redecode_numbers(_extended(ref), cell, llr, labels, traj,
                                 detected)


def counters(codeword, llr, ref, iters: int, schedule, block_frames: int,
             round_fn=None):
    """The fused step's counters rule (``decode.compact_counters``) on the
    extended matrix."""
    return NMS1.counters(codeword, llr, _extended(ref), iters, schedule,
                         block_frames, round_fn)
