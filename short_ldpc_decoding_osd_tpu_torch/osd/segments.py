"""MRB segmentation and test-error-pattern (TEP) block construction.

All of this is host-side, trace-time work producing *static* arrays
(SURVEY.md §7 decision 4): the decoding path is <= 30 order patterns over 6
MRB segments, each pattern expanding to a block of 0/1 TEP rows.

Reference semantics:
* 6-way MRB split ``[1] + (k-1 split prop. to 1:2:3:4:5)`` —
  ``DL_Training_serial/globalmap.py:66-85`` (``secure_segment_threshold``).
* 3-way split at ``k//6`` and ``3k//6`` for the conventional path —
  ``DL_OSD_Testing_serial/ordered_statistics_decoding.py:100-118``.
* TEP block for an order pattern = cartesian product of per-segment index
  combinations — ``ordered_statistics_decoding.py:81-98``.

A copy of ``short_ldpc_decoding_osd_tpu/osd/segments.py`` (host numpy): the
port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import itertools
import math

import numpy as np


def segment_sizes(k: int, num_segments: int = 6) -> np.ndarray:
    """Reference 6-way MRB segmentation: [1] then k-1 split prop. 1:2:..:s-1."""
    alloc = k - 1
    basic = list(range(1, num_segments))
    total = sum(basic)
    sizes = [int(alloc / total * b) for b in basic]
    sizes[-1] += alloc - sum(sizes)
    return np.asarray([1] + sizes, dtype=np.int64)


def segment_boundaries(k: int, num_segments: int = 6) -> np.ndarray:
    """Cumulative boundaries, length num_segments+1, starting at 0."""
    return np.concatenate([[0], np.cumsum(segment_sizes(k, num_segments))])


def convention_ranges(k: int, factor_gap: int = 6) -> list[range]:
    """3-way LR/MR/HR split used by the conventional decoding path."""
    d1 = k // factor_gap
    d2 = 3 * d1
    return [range(d1), range(d1, d2), range(d2, k)]


def pattern_block_size(pattern, sizes) -> int:
    """Number of TEPs for an order pattern = prod C(seg_size, w)."""
    return int(
        np.prod([math.comb(int(s), int(w)) for s, w in zip(sizes, pattern)])
    )


def expand_pattern(pattern, ranges, k: int) -> np.ndarray:
    """All 0/1 TEP rows (block) for one order pattern.

    ``pattern[i]`` ones are placed in segment ``ranges[i]`` in all possible
    ways (cartesian product of per-segment combinations)."""
    per_segment = []
    for rng, w in zip(ranges, pattern):
        w = int(w)
        if w == 0:
            per_segment.append([()])
        else:
            per_segment.append(list(itertools.combinations(rng, w)))
    rows = []
    for combo in itertools.product(*per_segment):
        row = np.zeros(k, dtype=np.int8)
        for group in combo:
            row[list(group)] = 1
        rows.append(row)
    return np.stack(rows) if rows else np.zeros((0, k), dtype=np.int8)


def ranges_from_boundaries(boundaries) -> list[range]:
    return [
        range(int(boundaries[i]), int(boundaries[i + 1]))
        for i in range(len(boundaries) - 1)
    ]


def build_tep_blocks(
    decoding_path, k: int, num_segments: int = 6, convention: bool = False
) -> tuple[list[np.ndarray], np.ndarray]:
    """TEP blocks + cumulative block sizes for a decoding path.

    Returns (blocks, acc_sizes) with ``acc_sizes[0] == 0`` — matches
    ``generate_teps`` (``DL_Training_serial/interval_boundary.py:252-265``).
    With ``convention=True`` the 3-way LR/MR/HR split is used instead of the
    6-segment learned split (``collect_tep``,
    ``DL_OSD_Testing_serial/ordered_statistics_decoding.py:100-118``)."""
    if convention:
        ranges = convention_ranges(k)
    else:
        ranges = ranges_from_boundaries(segment_boundaries(k, num_segments))
    blocks = [expand_pattern(p, ranges, k) for p in decoding_path]
    acc = np.concatenate([[0], np.cumsum([b.shape[0] for b in blocks])])
    return blocks, acc


def pack_tep_chunks(blocks: list[np.ndarray], chunk: int = 256):
    """Concatenate TEP blocks densely and split into fixed-size chunks.

    ``stack_padded_blocks`` pads every block to the LARGEST block, which for
    the learned 30-pattern path wastes ~4.5x the device work (1286 real TEPs
    vs 30x192 padded at k=64).  Here blocks are concatenated contiguously
    (so per-block minima are static slices of the flat axis) and chunked
    only for the device scan.

    Returns (teps (C, chunk, k) int8, mask (C, chunk) bool, bounds) where
    ``bounds`` is a hashable tuple of per-block (start, stop) flat indices —
    pass it as the static ``bounds`` argument of
    ``engine.block_discrepancy_minima`` / ``engine.sliding_osd``."""
    k = blocks[0].shape[1]
    sizes = [b.shape[0] for b in blocks]
    ntot = int(np.sum(sizes))
    c = -(-ntot // chunk)
    flat = np.zeros((c * chunk, k), dtype=np.int8)
    flat[:ntot] = np.concatenate(blocks, axis=0)
    mask = np.zeros(c * chunk, dtype=bool)
    mask[:ntot] = True
    acc = np.concatenate([[0], np.cumsum(sizes)])
    bounds = tuple(
        (int(acc[i]), int(acc[i + 1])) for i in range(len(blocks))
    )
    return flat.reshape(c, chunk, k), mask.reshape(c, chunk), bounds


def stack_padded_blocks(blocks: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-size TEP blocks into (P, Nmax, k) + validity mask
    (P, Nmax) so the whole path runs as one fixed-shape scan on device."""
    nmax = max(b.shape[0] for b in blocks)
    k = blocks[0].shape[1]
    stacked = np.zeros((len(blocks), nmax, k), dtype=np.int8)
    mask = np.zeros((len(blocks), nmax), dtype=bool)
    for i, b in enumerate(blocks):
        stacked[i, : b.shape[0]] = b
        mask[i, : b.shape[0]] = True
    return stacked, mask


def conventional_path(order_sum: int, num_segments: int = 3) -> list[list[int]]:
    """All order patterns over the first `num_segments` segments with
    sum <= order_sum, deduplicated, in the reference's enumeration order
    (``query_convention_path``, ``interval_boundary.py:90-106``)."""
    path = []
    seen = set()
    for i in range(order_sum + 1):
        for combo in itertools.product(range(order_sum + 1), repeat=num_segments):
            if sum(combo) <= i and combo not in seen:
                seen.add(combo)
                path.append(list(combo))
    return path
