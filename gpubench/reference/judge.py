"""The numbers that decide ``correct``: what the timed path produced,
held against the plain reference.

Two-phase rounds are judged stage by stage.  The capture starts from the
seed; each later stage of the reference starts from the outputs the
system gave the stage before it (its captured rows, its re-decode, its
refinement, its preparation, its minima), so that a difference in one
stage is read in that stage and nowhere else:

* the capture and the re-decode: the numbers of the configuration's
  decoder, from its file ``variants/<variant>.py`` (``ref["decoder"]``;
  NMS-1's ``capture_mismatch`` and ``redecode_mismatch``);
* ``dia_gap``: the largest ``|refined - ref| / (1 + |ref|)``;
* ``prepare_mismatch``: rows whose column order (of the refined values,
  the channel LLRs and the labels), hard decisions (of both), channel
  magnitudes, M, swap count or LRB ranks differ, each exactly: the later
  stages take the system's hard decisions and magnitudes, so a fault in
  them is read here;
* ``minima_gap``: the largest ``|minimum - ref| / (1 + |ref|)`` over the
  blocks, and of the reference's discrepancy at the system's chosen TEP
  against the reference's minimum;
* ``walk_mismatch``: rows whose ``success`` or ``strict_success`` differ,
  leaving out a row whose walk came within ``TIE`` of another stop or of
  the success threshold in the reference (counted as ``walk_ties``).

A fused Monte-Carlo step is judged by ``counter_mismatch``: the summed
absolute difference of its six counters from ``reference_counters``, by
the decoder's counters rule.
"""

from __future__ import annotations

import torch

from ..core import SpecError
from . import osd, sampling

TIE = 1e-5


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(torch.float64)
    gap = (got.to(torch.float64) - want).abs() / (1.0 + want.abs())
    return float(gap.max()) if gap.numel() else 0.0


def rows_per_block(n_rows: int, budget_elems: int, width: int) -> int:
    """Rows a block of a blocked computation whose rows are ``width``
    elements wide, within ``budget_elems``."""
    return max(1, min(n_rows, budget_elems // max(width, 1)))


def stage_numbers(ref, cell, llr, labels, traj, refined, prep, minima,
                  argmins, success, strict, mode: str = "f64") -> dict:
    """``dia_gap``, ``prepare_mismatch``, ``minima_gap``, ``walk_mismatch``
    and ``walk_ties`` of one round's phase 2, each stage from the system's
    own previous stage (``prep`` has the fields of the system's prepared
    batch)."""
    out = {}
    traj_b = traj.permute(1, 0, 2)
    want = osd.refine(traj_b, ref["taps"], ref["bias"], mode)
    out["dia_gap"] = _gap(refined, want)
    del want

    k = ref["k"]
    want = osd.prepare(refined, llr, labels, ref["h_osd"], k)
    differ = torch.zeros(len(llr), dtype=torch.bool, device=llr.device)
    for key in ("order_updated", "order_original", "order_labels",
                "hard_original", "hard_updated", "mag_original"):
        a, b = getattr(prep, key), want[key]
        differ |= (a.contiguous().view(-1, a.shape[1]).to(torch.float64)
                   != b.to(torch.float64)).any(1)
    differ |= (prep.m_matrix != want["m_matrix"]).flatten(1).any(1)
    differ |= prep.swap_len.to(torch.int64) != want["swap_len"].to(torch.int64)
    differ |= (prep.lrb_ranks.to(torch.int64) != want["lrb_ranks"]).any(1)
    out["prepare_mismatch"] = int(differ.sum())
    del want

    teps, valid, bounds = ref["teps"], ref["valid"], ref["bounds"]
    rows = rows_per_block(len(llr), ref["disc_budget"],
                          teps.shape[0] * prep.m_matrix.shape[1])
    gap = 0.0
    starts = torch.as_tensor([s for s, _ in bounds], device=llr.device)
    for s in range(0, len(llr), rows):
        sl = slice(s, s + rows)
        disc = osd.discrepancies(prep.m_matrix[sl], prep.hard_original[sl],
                                 prep.mag_original[sl], prep.hard_updated[sl],
                                 teps, mode)
        low, _ = osd.block_minima(disc, valid, bounds)
        real = low < osd.BIG
        gap = max(gap, _gap(minima[sl][real], low[real]))
        chosen = torch.gather(disc, 1, starts[None, :] + argmins[sl])
        gap = max(gap, _gap(chosen[real], low[real]))
        del disc
    out["minima_gap"] = gap

    fields = {"m_matrix": prep.m_matrix, "hard_original": prep.hard_original,
              "mag_original": prep.mag_original,
              "hard_updated": prep.hard_updated,
              "order_labels": prep.order_labels}
    dec = osd.decisions(fields, minima, argmins, teps, bounds, ref["w1"],
                        ref["w2"], cell["window"], cell["soft_margin"], mode)
    differ = (dec["success"] != success) | (dec["strict_success"] != strict)
    tie = (dec["margin"] < TIE) | (dec["success_margin"] < TIE)
    out["walk_mismatch"] = int((differ & ~tie).sum())
    out["walk_ties"] = int((differ & tie).sum())
    return out


def reference_counters(ref, cell, seed: int):
    """The six counters of the fused step of 32-bit seed ``seed`` by the
    reference's rule, with the frame-iterations and decisions its frames
    need (for the roofline)."""
    rule = getattr(ref["decoder"], "counters", None)
    if rule is None:
        raise SpecError(f"the decoder {ref['decoder'].__file__} has no "
                        "counters rule for a fused step")
    total = [0] * 6
    frame_iters = closings = 0
    chunk = ref["chunk"]
    for start in range(0, cell["batch"], chunk):
        fid = torch.arange(start, min(cell["batch"], start + chunk),
                           dtype=torch.int64, device=ref["g"].device)
        codeword, llr = sampling.hash_frames(fid, seed, ref["g"], ref["sigma"])
        c, fi, cl = rule(codeword, llr, ref, cell["iters"], cell["schedule"],
                         cell["block_frames"], ref.get("round_fn"))
        total = [a + b for a, b in zip(total, c)]
        frame_iters += fi
        closings += cl
    return total, frame_iters, closings


def counter_mismatch(got, want) -> int:
    return sum(abs(int(a) - int(b)) for a, b in zip(got, want))
