"""FS-OSD (fast-and-scalable OSD, Choi & Jeong 2019) — batched redesign.

Port of ``short_ldpc_decoding_osd_tpu/baselines/fs_osd.py``.  The reference
walks TEPs one at a time in Python with three data-dependent stops
(``FS_OSD/fs_testing.py:129-176``).  Here the same *semantics* are
reproduced without a serial loop:

1. the TEP visiting order is static (order-1..L, each order in the
   deterministic reversed-combination sequence of
   ``generate_sequential_teps``, ``fs_testing.py:32-49``);
2. hard/weighted distances for every TEP come from one pass over the TEP
   matrix (the parity terms on kernel K5, one launch per weight);
3. the three stopping rules become prefix scans over the visiting order:
   * tau_e: stop at the first TEP with hard distance < tau_e,
   * tau_psc: a TEP only updates the running best when its hard distance is
     below tau_psc (masked exclusive cumulative min),
   * per-order PNC bound: order j is entered only if its reliability lower
     bound (+ beta*(n-k) slack) is below the running best at its boundary.

``score_tau_e_codeword`` switches the scoring of a tau_e mid-search stop
as in JAX: True (the default) scores the tau_e codeword; False reproduces
the reference's literal line-162 scoring of the stale best-so-far
(``fs_testing.py:143-162``).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..ops.nms import first_argmin, first_index
from . import common


def sequential_tep_matrix(k: int, order_limit: int) -> tuple[np.ndarray, np.ndarray]:
    """TEPs of order 1..order_limit in the FS visiting order.

    Order-j sequence: for each combination (ascending lexicographic) of j
    positions, set those bits then reverse the vector
    (``generate_sequential_teps``)."""
    n_teps = sum(math.comb(k, w) for w in range(1, order_limit + 1))
    if n_teps > 4_000_000:
        raise ValueError(
            f"FS baseline TEP set C({k},<= {order_limit}) = {n_teps:,} rows "
            "is impractical for large k; lower order_limit (see pb_osd."
            "weight_limited_teps for the rationale)"
        )
    rows = []
    starts = [0]
    for w in range(1, order_limit + 1):
        for combo in itertools.combinations(range(k), w):
            row = np.zeros(k, dtype=np.int8)
            row[list(combo)] = 1
            rows.append(row[::-1])
        starts.append(len(rows))
    return np.stack(rows), np.asarray(starts)


def pnc_bounds(inputs_sorted: torch.Tensor, k: int, order_limit: int) -> torch.Tensor:
    """(B, L) per-order reliability lower bounds: cumulative sums of the
    least-reliable MRB magnitudes (``acquire_pnc_boundary``,
    ``fs_testing.py:22-30``)."""
    tail = inputs_sorted[:, :k].abs().flip(1)  # ascending within MRB tail
    return torch.cumsum(tail[:, :order_limit], 1)


def _exclusive_cummin(x: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """runmin[i] = min(init, x[0..i-1]) along the last axis (exact)."""
    cm = torch.cummin(x, dim=-1).values
    shifted = torch.cat([torch.full_like(x[..., :1], math.inf), cm[..., :-1]], -1)
    return torch.minimum(shifted, init[..., None])


def fs_osd(
    inputs,
    labels,
    g,
    k: int,
    order_limit: int = 3,
    beta: float = 0.1,
    d_min: int = 14,
    tau_psc: int = 30,
    chunk: int = 2048,
    score_tau_e_codeword: bool = True,
    device: str | torch.device = "cuda",
):
    """Batched FS-OSD.  Returns per-frame success flags + TEP counts.
    ``chunk`` is accepted for API parity and changes nothing
    (``common``'s docstring)."""
    inputs, labels = common.as_batch(inputs, labels, device)
    dev = inputs.device
    n = inputs.shape[1]
    teps, starts = sequential_tep_matrix(k, order_limit)
    n_teps = teps.shape[0]
    tau_e = math.floor(d_min - 1) / 2
    teps_t = torch.as_tensor(teps, device=dev)

    prep = common.prepare_g_domain(inputs, labels, g, k)
    terms = common.candidate_distance_terms(prep, k)
    # distances for every TEP in visiting order
    wd, hd = common.tep_distances(terms, teps_t, prep["p_matrix"])

    wd0 = terms["c_w"]  # zero-TEP weighted distance
    zero_stop = terms["c_h"] < tau_e

    # running best (exclusive) under the tau_psc update rule
    psc_ok = hd < tau_psc
    runmin = _exclusive_cummin(torch.where(psc_ok, wd, math.inf), wd0)  # (B, N)

    # order gating: order j entered iff bound_j < runmin at its start index
    bounds = pnc_bounds(prep["inputs"], k, order_limit) + beta * (n - k)  # (B, L)
    start_idx = torch.as_tensor(starts[:-1], device=dev)
    gate_fail = bounds >= runmin[:, start_idx]  # (B, L)
    any_gate_fail = gate_fail.any(1)
    gate_stop_idx = torch.where(
        any_gate_fail, start_idx[first_index(gate_fail, 1)], n_teps
    )  # index of first TEP NOT processed

    # tau_e stop: first index with hd < tau_e, if before the gate stop
    e_mask = hd < tau_e
    first_e = first_index(e_mask, 1)
    e_stop_valid = e_mask.any(1) & (first_e < gate_stop_idx)

    processed = torch.where(e_stop_valid, first_e + 1, gate_stop_idx)
    num_teps = 1 + torch.where(zero_stop, 0, processed)

    # final TEP: tau_e winner, else the runmin argmin among processed TEPs;
    # literal reference semantics (score_tau_e_codeword=False): the frame is
    # judged on the best psc-qualified codeword found BEFORE the tau_e TEP
    idx = torch.arange(n_teps, device=dev)[None, :]
    scored_lim = torch.where(
        e_stop_valid, first_e + 1 if score_tau_e_codeword else first_e,
        gate_stop_idx)
    wd_masked = torch.where(psc_ok & (idx < scored_lim[:, None]), wd, math.inf)
    best_idx = first_argmin(wd_masked, 1)
    best_wd = wd_masked.amin(1)
    chosen_is_e = e_stop_valid & ~zero_stop & score_tau_e_codeword
    chosen_idx = torch.where(chosen_is_e, first_e, best_idx)
    use_zero = ~chosen_is_e & (zero_stop | (best_wd >= wd0))

    tep_sel = torch.where(use_zero[:, None], 0.0,
                          teps_t[chosen_idx].to(torch.float32))
    return {
        "success": common.reencode_success(terms, prep, tep_sel),
        "num_teps": num_teps,
        "zero_stop": zero_stop,
        "tau_e_stop": e_stop_valid,
        "gate_stop": any_gate_fail & ~e_stop_valid,
    }
