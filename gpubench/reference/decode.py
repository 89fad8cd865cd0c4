"""Normalized min-sum decoding, the capture rule and the fused counters'
compaction rule, in plain PyTorch.

The decoder keeps the edge order of ``codes.edges``: a variable sums its
incoming messages in ascending check order, a check scans its slots in
order for the minimum and the second minimum.  Those orders make every
f32 rounding, and so every hard decision, the same as the system's; a
decoder that summed in another order would differ in the last bit and
flip a frame near a decision boundary now and then.

``round_fn`` rounds the channel input and every new message (the control:
bfloat16 storage); None keeps float32.
"""

from __future__ import annotations

import numpy as np
import torch


class Tables:
    """The edge tables of a parity matrix on one device."""

    def __init__(self, h: np.ndarray, edge_col: np.ndarray,
                 var_edges: np.ndarray, device):
        self.h = torch.as_tensor(h, dtype=torch.float32, device=device)
        self.dc, self.m = edge_col.shape
        self.n = var_edges.shape[1]
        self.valid = torch.as_tensor(edge_col >= 0, device=device)
        self.cols = torch.as_tensor(np.maximum(edge_col, 0), device=device)
        num_edges = self.dc * self.m
        self.var_idx = torch.as_tensor(
            np.where(var_edges >= 0, var_edges, num_edges), device=device)


def decode(llr: torch.Tensor, t: Tables, iters: int, weights, slots,
           round_fn=None) -> dict:
    """Soft outputs ``colsum + w_marg * llr`` after each iteration in
    ``slots`` (slot 0 is ``llr`` itself), as {slot: (B, n) f32}."""
    w_vc, w_chk, w_marg = weights
    if round_fn is not None:
        llr = round_fn(llr)
    batch = llr.shape[0]
    num_edges = t.dc * t.m
    cv = torch.zeros(batch, num_edges + 1, dtype=torch.float32, device=llr.device)
    out = {0: llr} if 0 in slots else {}
    for it in range(iters + 1):
        s = torch.zeros(batch, t.n, dtype=torch.float32, device=llr.device)
        for d in range(t.var_idx.shape[0]):
            s = s + cv[:, t.var_idx[d]]
        if it > 0 and it in slots:
            out[it] = s + w_marg * llr
        if it == iters:
            break
        total = s + w_vc * llr
        vc = total[:, t.cols] - cv[:, :num_edges].view(batch, t.dc, t.m)
        mag = torch.where(t.valid, vc.abs(), torch.inf)
        sgn = torch.where(vc > 0, 1.0, torch.where(vc < 0, -1.0, 0.0))
        sgn = torch.where(t.valid, sgn, 1.0)
        min1 = torch.full((batch, t.m), torch.inf, device=llr.device)
        min2 = torch.full((batch, t.m), torch.inf, device=llr.device)
        sign = torch.ones((batch, t.m), device=llr.device)
        for j in range(t.dc):
            min2 = torch.minimum(min2, torch.maximum(min1, mag[:, j]))
            min1 = torch.minimum(min1, mag[:, j])
            sign = sign * sgn[:, j]
        emag = torch.where(mag > min1[:, None], (w_chk * min1)[:, None],
                           (w_chk * min2)[:, None])
        new = torch.where(t.valid, emag * (sign[:, None] * sgn), 0.0)
        if round_fn is not None:
            new = round_fn(new)
        cv[:, :num_edges] = new.reshape(batch, num_edges)
    return out


def frame_stats(soft: torch.Tensor, words: torch.Tensor, h: torch.Tensor):
    """(bit errors (B,) int64, detected (B,) bool): the hard decision
    ``soft < 0`` against the sent word, and a nonzero syndrome."""
    hard = (soft < 0).to(torch.float32)
    bit_err = (hard != words.to(torch.float32)).sum(1)
    synd = hard @ h.T
    detected = (synd - 2.0 * torch.floor(synd * 0.5) != 0).any(1)
    return bit_err.to(torch.int64), detected


def count(bit_err: torch.Tensor, detected: torch.Tensor) -> list[int]:
    """[frames, frame errors, bit errors, detected, undetected]."""
    fe = bit_err > 0
    return [len(bit_err), int(fe.sum()), int(bit_err.sum()),
            int(detected.sum()), int((fe & ~detected).sum())]


def capture(detected: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows of the capture buffer: the detected failures in frame order,
    then the other frames in frame order, the first ``cap`` of them."""
    order = torch.cat([torch.nonzero(detected)[:, 0],
                       torch.nonzero(~detected)[:, 0]])
    return order[:cap]


def rows_schedule(schedule, block_frames: int, iters: int):
    """((iters, frac), ...) -> ((iters, rows), ...), the remaining
    iterations: a stage's rows are ``int(block * frac)`` floored at 64,
    rounded down to a multiple of 8 and at most the previous stage's rows
    less 8; a stage that leaves no iteration after it, or would hold fewer
    than 64 rows, ends the schedule."""
    out, spent, prev = [], 0, block_frames
    for stage_iters, frac in schedule:
        if spent + stage_iters >= iters:
            break
        rows = min(max(64, int(block_frames * frac)) // 8 * 8, prev - 8)
        if rows < 64:
            break
        out.append((stage_iters, rows))
        prev, spent = rows, spent + stage_iters
    return out, iters - spent


def compact_counters(codeword, llr, t: Tables, iters: int, weights, schedule,
                     block_frames: int, round_fn=None):
    """The fused counters' rule on one group-aligned slice of frames: at
    each stage boundary a frame with a zero syndrome keeps that decision;
    of each group's still-alive unconverged frames the first ``rows`` (in
    frame order) go on and the rest keep the stage's decision and count as
    overflow; the others are judged after all iterations.  Returns the six
    counters, the frame-iterations these frames need under the schedule
    and their decisions taken (one at each boundary a frame reaches)."""
    stages, _ = rows_schedule(schedule, block_frames, iters)
    bounds, spent = [], 0
    for stage_iters, _ in stages:
        spent += stage_iters
        bounds.append(spent)
    soft = decode(llr, t, iters, weights, set(bounds) | {iters}, round_fn)
    decision = soft[iters]
    alive = torch.ones(len(llr), dtype=torch.bool, device=llr.device)
    overflow = frame_iters = 0
    closings = len(llr)
    start = 0
    for (_, rows), at in zip(stages, bounds):
        frame_iters += int(alive.sum()) * (at - start)
        _, unconv = frame_stats(soft[at], codeword, t.h)
        u = (alive & unconv).view(-1, block_frames)
        rank = torch.cumsum(u, 1) - u.to(torch.int64)
        covered = (u & (rank < rows)).view(-1)
        decision = torch.where((alive & ~covered)[:, None], soft[at], decision)
        overflow += int((alive & unconv & ~covered).sum())
        alive, start = covered, at
        closings += int(alive.sum())
    frame_iters += int(alive.sum()) * (iters - start)
    bit_err, detected = frame_stats(decision, codeword, t.h)
    return count(bit_err, detected) + [overflow], frame_iters, closings
