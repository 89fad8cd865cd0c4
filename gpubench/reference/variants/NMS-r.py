"""NMS-r: the check-node magnitude of a non-negative two-layer network over
the sorted magnitudes of the row's other edges, with two trained bit
scalars (the reference code's ``compute_cv1``,
``Ldpc_128_training/ms_decoder_dense.py:143-175``).

Per iteration, on the edge tables of ``decode.Tables`` (a regular check
degree dc): the variable totals sum each variable's messages in
ascending check order and add ``w_vc * llr``; an edge's sign is the
parity of the row's other negative edges, zero where the row has a zero;
its magnitude is the ascending sort of the row's other dc-1 magnitudes
through ``(x @ w1) @ w2``, each product an explicit f32 sum in ascending
index order.  The soft output adds ``w_marg * llr``.  Every operand is
float32 and no product runs on TF32.

The system evaluates the same mathematics in other orders (the padded
edge layout, cuBLAS's products), so its values differ from these in the
last bits.  Two things follow.  A sign decision near zero may fall either
way.  And a check input that crosses zero flips the sign of its row's
other messages, whose magnitudes (the network weighs every sorted entry)
are not near zero: from there on the frame's trajectory is another one.
So the checks compare frames by frame index, judge only the frames that
stayed clear of both, and hold the structure of the capture exactly:

* ``capture_differ``: the capture's structure, exact: the frame count,
  the detected count against the buffer's count, a captured row that is
  no frame of the round (LLR bits) or holds another sent word, a row out
  of the capture rule's order (the detected frames in frame order, then
  the first undetected frames in frame order);
* ``capture_decided_differ``: the judged frames (every frame, or with an
  overflow those up to the last captured one) whose detected flag
  differs from the reference's, and how far the frame-error, bit-error
  and undetected counters lie outside the range the near-tie frames
  allow (each may take any value there);
* ``redecode_gap``: the largest ``|got - ref| / (1 + |ref|)`` of the
  re-decode trajectory over the rows clear of a tie;
* ``redecode_decided_differ``: the detected flags of the last slot that
  differ on rows clear of a tie;
* ``redecode_tie_share``: the share of the captured rows that are near a
  tie, which the two numbers before leave out.

A frame is near a tie when a check input came within ``TIE`` of zero,
relative to ``1 +`` its frame's largest check input that iteration, or
when a bit of its last soft output lies within ``DECIDE`` of zero.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import artifacts, decode, sampling

# distance of a check input from zero, relative to 1 + its frame's largest
# that iteration, within which the system's other f32 order may give it the
# other sign: the orders part by up to ~1e-6 of the values (the largest
# sound re-decode gap on the card 1.14e-5 of 1 + |value|, at values near
# 10), so 3x that; the six inputs that crossed zero on the card (two
# rounds) read 1.5e-8 to 7.7e-7 in absolute value
TIE = 3e-6
# |soft output| within which a bit's decision may fall either way: the
# re-decode's gap limit, 3e-4, moves a value near zero by up to that much
DECIDE = 3e-4
# frames a block of the reference decode: its sort holds (B, dc, dc-1, m)
BLOCK = 16384


def weights(nms_params: dict) -> dict:
    """``w_vc`` and ``w_marg``, the softplus of ``bit1`` and ``bit2``, and
    the network's ``w1`` (dc-1, 4) and ``w2`` (4, 1) as stored."""
    def scalar(name):
        return artifacts.softplus_f32(
            float(np.asarray(nms_params[name]).reshape(-1)[0]))
    return {"w_vc": scalar("bit1"), "w_marg": scalar("bit2"),
            "w1": np.asarray(nms_params["nn_w1"], np.float32),
            "w2": np.asarray(nms_params["nn_w2"], np.float32)}


def _products(x, w1, w2, operand_fn):
    """``(x @ w1) @ w2`` over the last axis of ``x``, each sum in ascending
    index order; ``operand_fn`` rounds every operand of both products."""
    if operand_fn is not None:
        x, w1, w2 = operand_fn(x), operand_fn(w1), operand_fn(w2)
    out = None
    for j in range(w1.shape[1]):
        hidden = x[..., 0] * w1[0, j]
        for i in range(1, w1.shape[0]):
            hidden = hidden + x[..., i] * w1[i, j]
        if operand_fn is not None:
            hidden = operand_fn(hidden)
        term = hidden * w2[j, 0]
        out = term if out is None else out + term
    return out


def _decode_block(llr, t, iters, w, slots, round_fn, operand_fn):
    """(soft outputs {slot: (B, n)}, each frame's smallest |check input|
    relative to 1 + its largest that iteration (B,))."""
    if round_fn is not None:
        llr = round_fn(llr)
    batch, dev = llr.shape[0], llr.device
    dc, m, num_edges = t.dc, t.m, t.dc * t.m
    w1 = torch.as_tensor(w["w1"], device=dev)
    w2 = torch.as_tensor(w["w2"], device=dev)
    others = torch.tensor([[q for q in range(dc) if q != p] for p in range(dc)],
                          device=dev)
    cv = torch.zeros(batch, num_edges + 1, dtype=torch.float32, device=dev)
    out = {0: llr} if 0 in slots else {}
    low = torch.full((batch,), torch.inf, device=dev)
    for it in range(iters + 1):
        s = torch.zeros(batch, t.n, dtype=torch.float32, device=dev)
        for d in range(t.var_idx.shape[0]):
            s = s + cv[:, t.var_idx[d]]
        if it > 0 and it in slots:
            out[it] = s + w["w_marg"] * llr
        if it == iters:
            break
        total = s + w["w_vc"] * llr
        vc = total[:, t.cols] - cv[:, :num_edges].view(batch, dc, m)
        mag = vc.abs()
        flat = mag.flatten(1)
        low = torch.minimum(low, flat.amin(1) / (1.0 + flat.amax(1)))
        neg = (vc < 0).sum(1, keepdim=True)
        row_sign = torch.where((vc == 0).any(1, keepdim=True), 0.0,
                               1.0 - 2.0 * (neg % 2).to(torch.float32))
        sgn = torch.where(vc > 0, 1.0, torch.where(vc < 0, -1.0, 0.0))
        loo = torch.sort(mag[:, others], dim=2).values  # (B, dc, dc-1, m)
        new = _products(loo.transpose(2, 3), w1, w2, operand_fn) * (row_sign * sgn)
        if round_fn is not None:
            new = round_fn(new)
        cv[:, :num_edges] = new.reshape(batch, num_edges)
    return out, low


def decode_rows(llr, ref, iters: int, slots, round_fn=None, operand_fn=None):
    """(soft outputs {slot: (B, n) f32}, crossed (B,) bool) of ``llr``,
    decoded in blocks of ``BLOCK`` frames; a frame has crossed when a
    check input came within ``TIE`` of zero.  ``operand_fn`` rounds the
    network's operands (the TF32 control)."""
    t = ref["tables"]
    if not bool(t.valid.all()):
        raise ValueError("NMS-r needs a regular check degree")
    parts = [_decode_block(llr[s:s + BLOCK], t, iters, ref["weights"], slots,
                           round_fn, operand_fn)
             for s in range(0, llr.shape[0], BLOCK)]
    soft = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    return soft, torch.cat([p[1] for p in parts]) < TIE


def soft_outputs(llr, ref, iters: int, slots, round_fn=None,
                 operand_fn=None) -> dict:
    """{slot: (B, n) f32} soft outputs of ``llr`` after each iteration in
    ``slots``."""
    return decode_rows(llr, ref, iters, slots, round_fn, operand_fn)[0]


def frame_index(rows: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """For each row of ``rows`` (R, n) f32, the index of the frame of
    ``frames`` (B, n) that holds the same bits, or -1 where none does: a
    64-bit key of the bits, matched by a sorted search and then checked
    bit for bit."""
    weights = ((torch.arange(frames.shape[1], dtype=torch.int64,
                             device=frames.device) * 2654435761 + 97531)
               & 0x7FFFFFFF)

    def key(x):
        return ((x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) * weights).sum(1)

    keys, order = torch.sort(key(frames))
    pos = torch.searchsorted(keys, key(rows)).clamp(max=len(keys) - 1)
    idx = order[pos]
    same = (frames[idx].view(torch.int32) == rows.view(torch.int32)).all(1)
    return torch.where(same, idx, -1)


def _out_of_order(idx: torch.Tensor) -> int:
    """Positions of ``idx`` not above their predecessor."""
    return int((idx[1:] <= idx[:-1]).sum())


def _outside(value: int, low: int, high: int) -> int:
    return max(low - value, value - high, 0)


def capture_numbers(ref, cell, index: int, counters, count, llr, labels) -> dict:
    """The capture of round ``index``: the reference draws and decodes the
    round again from the seed and finds each captured row's frame."""
    h = ref["tables"].h
    cap_b, iters = cell["cap_b"], cell["iters"]
    llr_all, words = sampling.awgn_round(cell["seed"], index, ref["g"], cap_b,
                                         ref["sigma"])
    soft, crossed = decode_rows(llr_all, ref, iters, {iters})
    _, detected = decode.frame_stats(soft[iters], words, h)
    # bits whose decision may fall either way, in frames that did not cross
    open_bits = (soft[iters].abs() < DECIDE) & ~crossed[:, None]
    near = crossed | open_bits.any(1)
    got = [int(x) for x in counters.tolist()]
    count = int(count)
    rows = len(llr)
    kept = min(count, rows)

    idx = frame_index(llr, llr_all)
    found = idx >= 0
    bad = int(got[0] != cap_b) + int(got[3] != count)
    bad += int((~found | (labels.to(torch.int32)
                          != words[idx.clamp(min=0)]).any(1)).sum())
    mine = torch.zeros(cap_b, dtype=torch.bool, device=llr_all.device)
    mine[idx[:kept][found[:kept]]] = True
    if count >= rows:
        # an overflow: the detected frames up to the last captured one
        judged = torch.arange(cap_b, device=llr_all.device) <= int(idx[-1])
        bad += _out_of_order(idx)
    else:
        judged = torch.ones(cap_b, dtype=torch.bool, device=llr_all.device)
        bad += _out_of_order(idx[:kept])
        bad += int((idx[kept:] != torch.nonzero(~mine)[:rows - kept, 0]).sum())
    differ = int((judged & (mine != detected) & ~near).sum())

    # each counter's least value over the frames and bits that are decided,
    # and how far the undecided ones can raise it
    wrong = ((soft[iters] < 0).to(torch.int32) != words) & ~open_bits & ~crossed[:, None]
    sure = wrong.any(1)
    ranges = (
        (got[1], int(sure.sum()),
         int(crossed.sum()) + int((open_bits.any(1) & ~sure).sum())),
        (got[2], int(wrong.sum()),
         h.shape[1] * int(crossed.sum()) + int(open_bits.sum())),
        (got[4], int((sure & ~detected & ~near).sum()), int(near.sum())),
    )
    differ += sum(_outside(v, lo, lo + width) for v, lo, width in ranges)
    return {"capture_differ": bad, "capture_decided_differ": differ}


def redecode_numbers(ref, cell, llr, labels, traj, detected) -> dict:
    """The re-decode of the captured rows: ``traj`` (T+1, B, n) and the
    detected flags of its last slot."""
    iters = cell["iters"]
    soft, crossed = decode_rows(llr, ref, iters, set(range(iters + 1)))
    want = torch.stack([soft[i] for i in range(iters + 1)], 0)
    near = crossed | (want[iters].abs() < DECIDE).any(1)
    clear = ~near
    gap = ((traj[:, clear] - want[:, clear]).abs()
           / (1.0 + want[:, clear].abs()))
    _, det = decode.frame_stats(want[iters], labels, ref["tables"].h)
    return {"redecode_gap": float(gap.max()) if gap.numel() else 0.0,
            "redecode_decided_differ": int(((det != detected) & clear).sum()),
            "redecode_tie_share": float(near.float().mean()) if len(near) else 0.0}
