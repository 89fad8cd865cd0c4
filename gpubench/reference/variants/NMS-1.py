"""NMS-1: normalized min-sum with one trained check weight, the softplus
of the run's ``check`` scalar, decoded by ``decode.decode``.

* ``capture_mismatch``: counters, the failure count, and captured rows
  (LLR bits or sent word) that differ from the reference's draw, decode
  and capture rule;
* ``redecode_mismatch``: re-decode trajectory values (bit for bit) and
  detected flags that differ.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import artifacts, decode, sampling


def weights(nms_params: dict) -> tuple:
    """(w_vc, w_chk, w_marg) of the run's ``nms_params.pkl``."""
    check = float(np.asarray(nms_params["check"]).reshape(-1)[0])
    return (1.0, artifacts.softplus_f32(check), 1.0)


def soft_outputs(llr, ref, iters: int, slots, round_fn=None) -> dict:
    """{slot: (B, n) f32} soft outputs of ``llr`` after each iteration in
    ``slots``."""
    return decode.decode(llr, ref["tables"], iters, ref["weights"], slots,
                         round_fn)


def capture_numbers(ref, cell, index: int, counters, count, llr, labels) -> dict:
    """The capture of round ``index``: the reference draws, decodes and
    captures the round again from the seed."""
    h = ref["tables"].h
    llr_all, words = sampling.awgn_round(cell["seed"], index, ref["g"],
                                         cell["cap_b"], ref["sigma"])
    soft = decode.decode(llr_all, ref["tables"], cell["iters"],
                         ref["weights"], {cell["iters"]})[cell["iters"]]
    bit_err, detected = decode.frame_stats(soft, words, h)
    want = decode.count(bit_err, detected)
    rows = decode.capture(detected, cell["cap"])
    got = [int(x) for x in counters.tolist()]
    bad = sum(int(a != b) for a, b in zip(got, want)) + int(int(count) != int(detected.sum()))
    bad += int(((llr.view(torch.int32) != llr_all[rows].view(torch.int32)).any(1)
                | (labels.to(torch.int32) != words[rows]).any(1)).sum())
    return {"capture_mismatch": bad}


def redecode_numbers(ref, cell, llr, labels, traj, detected) -> dict:
    """The re-decode of the captured rows: ``traj`` (T+1, B, n) and the
    detected flags of its last slot."""
    iters = cell["iters"]
    soft = decode.decode(llr, ref["tables"], iters, ref["weights"],
                         set(range(iters + 1)))
    want = torch.stack([soft[i] for i in range(iters + 1)], 0)
    bad = int((traj.contiguous().view(torch.int32) != want.view(torch.int32)).sum())
    _, det = decode.frame_stats(want[iters], labels, ref["tables"].h)
    return {"redecode_mismatch": bad + int((det != detected).sum())}


def counters(codeword, llr, ref, iters: int, schedule, block_frames: int,
             round_fn=None):
    """The fused step's counters rule (``decode.compact_counters``)."""
    return decode.compact_counters(codeword, llr, ref["tables"], iters,
                                   ref["weights"], schedule, block_frames,
                                   round_fn)
