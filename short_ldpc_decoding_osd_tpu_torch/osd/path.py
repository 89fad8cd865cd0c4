"""Decoding-path construction from MRB error-pattern statistics.

Port of ``short_ldpc_decoding_osd_tpu/osd/path.py`` (stage 3 of the recipe,
``DL_Training_serial``):

* for each NMS failure, sort the (DIA-refined) reliabilities ascending by
  magnitude, run GE to find the MRB, and record the 6-segment error-weight
  pattern of the MRB against the true codeword (``nn_training.py:518-575``);
  the GE is ``gf2ops.identify_mrb`` (the GE kernel's dense load on the card);
* rank patterns by ratio-normalized frequency (count / prod C(seg_size, w)),
  keep ``sum(pattern) <= threshold_sum``, truncate to ``decoding_length``
  (``nn_training.py:461-471``, ``interval_boundary.py:108-147``).
"""

from __future__ import annotations

import collections
import json
import math

import numpy as np
import torch

from ..ops import gf2ops
from . import segments


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mrb_error_patterns(updated: torch.Tensor, labels: torch.Tensor, h, k: int,
                       num_segments: int = 6):
    """Batched 6-segment MRB error-weight patterns.

    Returns (patterns, swap_len): patterns (B, num_segments) int32, the
    per-segment error weights of the (ascending-sorted) MRB against the
    labels; swap_len (B,).  Mirrors ``stat_pro_osd`` +
    ``evaluate_MRB_pattern`` (``nn_training.py:518-575``)."""
    boundaries = segments.segment_boundaries(k, num_segments)
    perm, h_p = gf2ops.reliability_sort(updated, h)
    info = gf2ops.identify_mrb(h_p, k)
    mrb_pos = info["index_order"][:, -k:]  # ascending reliability ranks
    full_perm = torch.gather(perm, 1, mrb_pos)  # original positions
    mrb_inputs = torch.gather(updated, 1, full_perm)
    mrb_labels = torch.gather(labels.to(torch.int32), 1, full_perm)
    diff = ((mrb_inputs <= 0).to(torch.int32) != mrb_labels).to(torch.int32)
    patterns = torch.stack(
        [diff[:, int(boundaries[s]):int(boundaries[s + 1])].sum(1)
         for s in range(num_segments)], 1).to(torch.int32)
    return patterns, info["swap_len"]


class PatternCounter:
    """Host-side accumulator of order-pattern statistics (the reference
    keeps a ``Counter`` keyed 'w1,...,w6')."""

    def __init__(self, k: int, num_segments: int = 6):
        self.k = k
        self.num_segments = num_segments
        self.sizes = segments.segment_sizes(k, num_segments)
        self.counts: collections.Counter = collections.Counter()
        self.total = 0
        self.swap_sum = 0

    def update(self, patterns, swap_len=None):
        patterns = _host(patterns)
        for row in patterns:
            self.counts[tuple(int(x) for x in row)] += 1
        self.total += len(patterns)
        if swap_len is not None:
            self.swap_sum += int(np.sum(_host(swap_len)))

    def ratio_normalized(self) -> dict:
        """count / prod C(seg_size, w) per pattern (``nn_training.py:461-471``)."""
        out = {}
        for pattern, count in self.counts.items():
            size = np.prod(
                [math.comb(int(s), int(w)) for s, w in zip(self.sizes, pattern)]
            )
            out[pattern] = count / max(size, 1)
        return out

    def decoding_path(self, threshold_sum: int = 3,
                      decoding_length: int = 30) -> list[list[int]]:
        """Patterns ranked by ratio-normalized frequency, descending,
        filtered to sum <= threshold_sum and truncated
        (``interval_boundary.py:108-147``).  The sort is stable: equal
        ratios keep the counter's key order."""
        ranked = sorted(self.ratio_normalized().items(), key=lambda kv: kv[1],
                        reverse=True)
        path = [list(p) for p, _ in ranked if sum(p) <= threshold_sum]
        return path[:decoding_length]

    def save(self, path: str):
        with open(path, "wt") as fh:
            json.dump(
                {
                    "k": self.k,
                    "num_segments": self.num_segments,
                    "total": self.total,
                    "swap_sum": self.swap_sum,
                    "counts": {",".join(map(str, key)): v
                               for key, v in self.counts.items()},
                },
                fh,
            )

    @classmethod
    def load(cls, path: str) -> "PatternCounter":
        with open(path, "rt") as fh:
            blob = json.load(fh)
        pc = cls(blob["k"], blob["num_segments"])
        pc.total = blob["total"]
        pc.swap_sum = blob.get("swap_sum", 0)
        for key, val in blob["counts"].items():
            pc.counts[tuple(int(x) for x in key.split(","))] = val
        return pc


def mrb_bit_error_histogram(updated: torch.Tensor, labels: torch.Tensor,
                            k: int) -> collections.Counter:
    """Counter of MRB bit-error weights *before* GE (the tail of the
    |value|-sorted word), mirrors ``evaluate_MRB_bit``
    (``nn_training.py:323-333``)."""
    order = torch.sort(updated.abs(), dim=-1, stable=True).indices
    s_inputs = torch.gather(updated, 1, order)
    s_labels = torch.gather(labels.to(torch.int32), 1, order)
    hard = (s_inputs <= 0).to(torch.int32)
    errs = (hard[:, -k:] != s_labels[:, -k:]).to(torch.int32).sum(1)
    return collections.Counter(_host(errs).tolist())
