"""Phase 2 of the two-phase system in plain PyTorch: the DIA refinement,
the OSD preparation, the TEP discrepancy minima and the stopper walk.

Semantics (``DL_OSD_Testing_serial/ordered_statistics_decoding.py``,
``DL_Training_serial/nn_net.py``):

* DIA ``model_cnn``: three bias-free VALID cross-correlations (1->8->4->2
  channels, 3 taps each) over a bit's (T+1)-slot trajectory, flattened in
  (time, channel) order, then a dense head with a bias.  The stack is
  linear, so it is one (T+1)-tap filter plus the bias;
* preparation: a stable ascending sort of |refined|, the column-permuted
  parity matrix reduced over GF(2) (pivot on the first row with a 1, else
  swap in the first later column with a 1 in the pivot row, full RREF),
  the k MRB columns re-sorted by reliability rank, and M, the map from the
  MRB to the LRB;
* the discrepancy of TEP t: the weighted Hamming distance between the
  original hard decision and the candidate ``MRB = base ^ t``,
  ``LRB = mod2(M @ MRB)``; per block of the path its minimum;
* the walk: windows of ``window`` block minima, sorted, with the step
  index, through the stopper (dense, dense, softmax); a window whose new
  block's minimum exceeds the running minimum is skipped; the walk stops at
  the first evaluated window that fires (``p > soft_margin``).  ``success``
  is the walk's minimum equal to the sent word's discrepancy within 1e-3
  relative; ``strict_success`` is the chosen candidate equal to the sent
  word.

``mode`` is ``"f64"`` (the reference: every contraction in float64) or
``"tf32"`` (the control: every contraction's operands rounded to TF32, 10
mantissa bits, and summed in f32).
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 3.4e38
REL_TOL = 1e-3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest TF32 value (ties to even)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def contract(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str):
    """``einsum(eq, a, b)`` in float64, or on TF32 operands in f32."""
    if mode == "f64":
        return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64))
    return torch.einsum(eq, tf32(a), tf32(b))


def dia_filter(conv, head_kernel, head_bias, slots: int):
    """(taps (slots,) f64, bias) of the DIA's linear conv stack."""
    def forward(x):  # x (N, time, channels)
        for w in conv:  # (3, in, out)
            span = x.shape[1] - w.shape[0] + 1
            x = sum(np.einsum("nti,io->nto", x[:, j:j + span], w[j])
                    for j in range(w.shape[0]))
        return x.reshape(len(x), -1) @ head_kernel[:, 0] + head_bias

    basis = np.concatenate([np.eye(slots), np.zeros((1, slots))])[:, :, None]
    out = forward(basis)
    return out[:slots] - out[slots], float(out[slots])


def refine(traj: torch.Tensor, taps, bias: float, mode: str) -> torch.Tensor:
    """(B, T+1, n) trajectories -> (B, n) refined reliabilities."""
    t = torch.as_tensor(taps, dtype=torch.float64, device=traj.device)
    if mode != "f64":
        t = t.to(torch.float32)
    return contract("btn,t->bn", traj, t, mode) + bias


def gf2_reduce(mat: torch.Tensor):
    """(B, m, n) 0/1 int8 -> RREF with column swaps: (reduced, col_order),
    ``col_order[b, pos]`` the column now at ``pos``."""
    mat = mat.clone()
    batch, m, n = mat.shape
    dev = mat.device
    bidx = torch.arange(batch, device=dev)
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    order = cols.expand(batch, n).clone()

    def first(mask):
        idx = torch.where(mask, torch.arange(mask.shape[1], device=dev),
                          mask.shape[1]).amin(1)
        return torch.where(idx == mask.shape[1], 0, idx)

    for t in range(m):
        in_col = (mat[:, :, t] > 0) & (rows >= t)
        has_pivot = in_col.any(1)
        pivot_row = torch.where(has_pivot, first(in_col), t)
        swap_col = torch.where(has_pivot, t,
                               first((mat[:, t, :] > 0) & (cols > t)))
        col_t = mat[:, :, t].clone()
        mat[:, :, t] = mat[bidx, :, swap_col]
        mat[bidx, :, swap_col] = col_t
        o_t = order[:, t].clone()
        order[:, t] = order[bidx, swap_col]
        order[bidx, swap_col] = o_t
        row_t = mat[:, t, :].clone()
        mat[:, t, :] = mat[bidx, pivot_row, :]
        mat[bidx, pivot_row, :] = row_t
        pivot = mat[:, t, t:]
        col = mat[:, :, t].clone()
        col[:, t] = 0
        mat[:, :, t:] ^= col[:, :, None] & pivot[:, None, :]
    return mat, order


def prepare(refined, llr, labels, h_osd: torch.Tensor, k: int) -> dict:
    """The preparation of one batch: the arrays in the final column order,
    M (B, m, k) int8, the swap count and the LRB's reliability ranks."""
    perm = torch.sort(refined.abs(), dim=1, stable=True).indices
    n = perm.shape[1]
    h_perm = h_osd.to(torch.int8).T[perm].transpose(1, 2).contiguous()
    reduced, order = gf2_reduce(h_perm)
    mrb_sorted, sort_idx = torch.sort(order[:, -k:], dim=1)
    index_order = torch.cat([order[:, : n - k], mrb_sorted], 1)
    tail = reduced[:, :, n - k:]
    m_matrix = torch.gather(tail, 2, sort_idx[:, None, :].expand(-1, tail.shape[1], -1))
    final = torch.gather(perm, 1, index_order)
    original = torch.gather(llr, 1, final)
    updated = torch.gather(refined, 1, final)
    return {
        "order_updated": updated,
        "order_original": original,
        "order_labels": torch.gather(labels.to(torch.int8), 1, final),
        "m_matrix": m_matrix.to(torch.int8),
        "swap_len": (order[:, -k:] < n - k).sum(1),
        "lrb_ranks": order[:, : n - k],
        "hard_original": (original <= 0).to(torch.int8),
        "hard_updated": (updated <= 0).to(torch.int8),
        "mag_original": original.abs(),
    }


def _mod2(x):
    return x - 2.0 * torch.floor(x * 0.5)


def discrepancies(m_matrix, hard_original, mag_original, hard_updated,
                  teps: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, N) discrepancy of every TEP row of ``teps`` (N, k) int8 for a
    prepared batch (its arrays in the final column order)."""
    m = m_matrix.shape[1]
    real = torch.float64 if mode == "f64" else torch.float32
    h_l = hard_original[:, :m].to(real)
    h_m = hard_original[:, m:].to(real)
    w_l = mag_original[:, :m].to(real)
    w_m = mag_original[:, m:].to(real)
    base = hard_updated[:, m:].to(real)
    v = _mod2(torch.einsum("bmk,bk->bm", m_matrix.to(real), base))
    e = v + h_l - 2.0 * v * h_l
    f = base + h_m - 2.0 * base * h_m
    c0 = (w_l * e).sum(1) + (w_m * f).sum(1)
    u_l = w_l * (1.0 - 2.0 * e)
    u_m = w_m * (1.0 - 2.0 * f)
    # parity of M @ T^T: 0/1 products with integer sums <= k < 2048, exact
    # in half precision on the card (and in f32 on the CPU)
    exact = torch.float16 if teps.device.type == "cuda" else torch.float32
    prods = torch.einsum("bmk,nk->bmn", m_matrix.to(exact), teps.to(exact))
    parity = _mod2(prods).to(real)
    lterm = contract("bm,bmn->bn", u_l, parity, mode)
    return c0[:, None] + lterm + contract("bk,nk->bn", u_m, teps.to(real), mode)


def block_minima(disc: torch.Tensor, valid: torch.Tensor, bounds):
    """(minima (B, P), argmins (B, P)) over each block's TEPs; an empty
    block reads ``BIG`` and 0."""
    disc = torch.where(valid[None, :], disc, torch.full_like(disc, BIG))
    mins, args = [], []
    for s, e in bounds:
        if e == s:
            mins.append(torch.full((disc.shape[0],), BIG, dtype=disc.dtype,
                                   device=disc.device))
            args.append(torch.zeros(disc.shape[0], dtype=torch.int64,
                                    device=disc.device))
            continue
        block = disc[:, s:e]
        low = block.amin(1)
        mins.append(low)
        hit = block == low[:, None]
        idx = torch.arange(e - s, device=disc.device)
        args.append(torch.where(hit, idx, e - s).amin(1))
    return torch.stack(mins, 1), torch.stack(args, 1)


def stopper(x: torch.Tensor, w1, w2, mode: str) -> torch.Tensor:
    """Probability that the stopper fires, (rows,)."""
    dev = x.device
    real = torch.float64 if mode == "f64" else torch.float32
    w1 = torch.as_tensor(w1, dtype=real, device=dev)
    w2 = torch.as_tensor(w2, dtype=real, device=dev)
    hidden = contract("ri,ij->rj", x, w1, mode)
    return torch.softmax(contract("ri,ij->rj", hidden, w2, mode), dim=1)[:, 1]


def walk(minima: torch.Tensor, w1, w2, window: int, soft_margin: float,
         mode: str) -> dict:
    """The stopper walk over block minima (B, P) for every row at once:
    ``stop_k``, ``deep_limit``, ``global_min`` and ``margin``, the least
    distance of an evaluated window's probability from ``soft_margin``
    up to the stop (how near the walk came to another stop)."""
    batch, blocks = minima.shape
    steps = blocks - window + 1
    dev = minima.device
    real = torch.float64 if mode == "f64" else torch.float32
    minima = minima.to(real)
    idx = (torch.arange(steps, device=dev)[:, None]
           + torch.arange(window, device=dev)[None, :])
    wins = torch.sort(minima[:, idx], dim=2).values
    kk = torch.arange(steps, dtype=real, device=dev)
    feats = torch.cat([wins, kk[None, :, None].expand(batch, steps, 1)], 2)
    prob = stopper(feats.reshape(batch * steps, window + 1), w1, w2, mode)
    prob = prob.reshape(batch, steps)
    cmin = torch.cummin(minima, 1).values
    skip = torch.cat([torch.zeros((batch, 1), dtype=torch.bool, device=dev),
                      minima[:, window:] > cmin[:, window - 1:-1]], 1)
    cand = ~skip & (prob > soft_margin)
    first = torch.where(cand, torch.arange(steps, device=dev), steps).amin(1)
    stop_k = torch.where(first == steps, steps - 1, first)
    deep = stop_k + window
    upto = torch.arange(steps, device=dev)[None, :] <= stop_k[:, None]
    gap = torch.where(upto & ~skip, (prob - soft_margin).abs(), torch.inf)
    return {
        "stop_k": stop_k,
        "deep_limit": deep,
        "global_min": torch.gather(cmin, 1, (deep - 1)[:, None])[:, 0],
        "margin": gap.amin(1),
    }


def decisions(prep: dict, minima, argmins, teps, bounds, w1, w2, window: int,
              soft_margin: float, mode: str) -> dict:
    """``success`` and ``strict_success`` of every row from a prepared
    batch (``m_matrix``, ``hard_original``, ``mag_original``,
    ``hard_updated``, ``order_labels``), its block minima and the index of
    each block's minimising TEP; with the walk's ``margin`` and the success
    test's relative ``success_margin``."""
    real = torch.float64 if mode == "f64" else torch.float32
    res = walk(minima, w1, w2, window, soft_margin, mode)
    labels = prep["order_labels"].to(torch.int8)
    hard = prep["hard_original"].to(torch.int8)
    truth = ((labels ^ hard).to(real) * prep["mag_original"].to(real)).sum(1)
    scale = torch.clamp(truth, min=1.0)
    dist = (res["global_min"] - truth).abs()
    success = dist <= REL_TOL * scale
    dev = minima.device
    blocks = minima.shape[1]
    in_walk = torch.arange(blocks, device=dev)[None, :] < res["deep_limit"][:, None]
    masked = torch.where(in_walk, minima.to(real), torch.full_like(minima, BIG, dtype=real))
    low = masked.amin(1, keepdim=True)
    best = torch.where(masked == low, torch.arange(blocks, device=dev), blocks).amin(1)
    starts = torch.as_tensor([s for s, _ in bounds], device=dev)
    inner = torch.gather(argmins, 1, best[:, None])[:, 0]
    tep = teps[starts[best] + inner].to(real)
    k = teps.shape[1]
    base = prep["hard_updated"][:, -k:].to(real)
    mrb = (base - tep).abs()
    lrb = _mod2(torch.einsum("bmk,bk->bm", prep["m_matrix"].to(real), mrb))
    strict = (torch.cat([lrb, mrb], 1) == labels.to(real)).all(1)
    return {
        "success": success,
        "strict_success": strict,
        "margin": res["margin"],
        "success_margin": (dist - REL_TOL * scale).abs() / scale,
    }
