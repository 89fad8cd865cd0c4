"""Conventional OSD (full order-<=L enumeration) + miracle-view oracle.

Port of ``short_ldpc_decoding_osd_tpu/baselines/conventional.py``, batched
redesigns of ``FS_OSD/convention_osd.py:13-77`` and
``FS_OSD/fs_testing.py:324-341``.  The TEP set is static; the whole batch
is scored at once (the parity term on kernel K5) and reduced by one
first-occurrence argmin.
"""

from __future__ import annotations

import collections
import itertools
import math

import numpy as np
import torch

from ..ops.nms import first_argmin
from . import common


def full_tep_matrix(k: int, order_limit: int) -> tuple[np.ndarray, np.ndarray]:
    """All TEPs of weight 0..order_limit (static), plus order boundaries.

    Row order inside each weight class follows the reference's
    sum-of-indices-descending sort (``convention_osd.py:13-26``) — the order
    only matters for phase attribution, which uses the boundaries."""
    n_teps = sum(math.comb(k, w) for w in range(order_limit + 1))
    if n_teps > 4_000_000:
        raise ValueError(
            f"conventional-OSD TEP set C({k},<= {order_limit}) = {n_teps:,} "
            "rows is impractical for large k; lower order_limit (see "
            "pb_osd.weight_limited_teps for the rationale)"
        )
    rows = [np.zeros(k, dtype=np.int8)]
    boundaries = [1]
    for w in range(1, order_limit + 1):
        combos = list(itertools.combinations(range(k), w))
        combos.sort(key=lambda c: -sum(c))
        for c in combos:
            row = np.zeros(k, dtype=np.int8)
            row[list(c)] = 1
            rows.append(row)
        boundaries.append(len(rows))
    return np.stack(rows), np.asarray(boundaries)


def conventional_osd(inputs, labels, g, k: int, order_limit: int = 3,
                     chunk: int = 2048, device: str | torch.device = "cuda"):
    """Batched conventional OSD.  Returns per-frame success, argmin index,
    and belonged phase (order of the chosen TEP).  ``chunk`` is accepted
    for API parity and changes nothing (``common``'s docstring)."""
    inputs, labels = common.as_batch(inputs, labels, device)
    teps, boundaries = full_tep_matrix(k, order_limit)
    teps_t = torch.as_tensor(teps, device=inputs.device)
    prep = common.prepare_g_domain(inputs, labels, g, k)
    terms = common.candidate_distance_terms(prep, k)
    wd, _ = common.tep_distances(terms, teps_t, prep["p_matrix"], with_hd=False)
    best = first_argmin(wd, 1)
    success = common.reencode_success(terms, prep, teps_t[best].to(torch.float32))
    phase = torch.searchsorted(torch.as_tensor(boundaries, device=inputs.device),
                               best, right=True)
    return {
        "success": success,
        "best_index": best,
        "phase": phase,
        "num_teps": teps.shape[0],
    }


def miracle_view(inputs, labels, g, k: int,
                 device: str | torch.device = "cuda") -> collections.Counter:
    """Histogram of true MRB error weights: the FER floor of any order-p OSD
    (``fs_testing.py:324-341``)."""
    inputs, labels = common.as_batch(inputs, labels, device)
    prep = common.prepare_g_domain(inputs, labels, g, k)
    hard = (prep["inputs"] <= 0).to(torch.int8)
    err = (hard[:, :k] != prep["labels"][:, :k]).to(torch.int32).sum(1)
    return collections.Counter(err.cpu().numpy().tolist())


def miracle_fer_floor(counter: collections.Counter, order: int) -> float:
    """P(true MRB error weight > order) — the residual FER of an ideal
    order-``order`` OSD."""
    total = sum(counter.values())
    bad = sum(v for w, v in counter.items() if w > order)
    return bad / max(total, 1)
