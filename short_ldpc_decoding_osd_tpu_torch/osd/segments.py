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
port keeps its own so that it never imports the JAX package.  Beside it,
:class:`TepLayout` puts one path's chunked TEPs on a device with the
tables that kernel K5 reduces them by, once, at set-up.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from ..ops import osd_disc


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

    Padding every block to the LARGEST block would, for the learned
    30-pattern path, waste ~4.5x the device work (1286 real TEPs vs 30x192
    padded at k=64).  Here blocks are concatenated contiguously
    (so per-block minima are static slices of the flat axis) and chunked
    only for the device scan.

    Returns (teps (C, chunk, k) int8, mask (C, chunk) bool, bounds) where
    ``bounds`` is a hashable tuple of per-block (start, stop) flat indices
    (:class:`TepLayout` holds all three on a device)."""
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


@dataclasses.dataclass(frozen=True, eq=False)
class TepLayout:
    """One decoding path's TEPs on a device in the chunked layout of
    :func:`pack_tep_chunks`, with the tables of K5's block minima
    (``ops.osd_disc.block_minima``): built once at set-up, read by every
    walk (``engine.block_discrepancy_minima``, ``engine.sliding_osd``)."""

    teps: torch.Tensor  # (C, chunk, k) int8
    mask: torch.Tensor  # (C, chunk) bool, True on the first ntot TEPs
    bounds: tuple  # each block's (start, stop) flat indices
    acc: torch.Tensor  # (P+1,) int64 cumulative block sizes, acc[0] = 0
    positions: tuple  # ``osd_disc.tep_positions`` of the flat rows
    block_of: torch.Tensor  # (C*chunk,) int32 each TEP's block, -1 for none
    starts: torch.Tensor  # (P,) int64 each block's first flat index
    ntot: int  # the end of the last block

    @classmethod
    def build(cls, decoding_path, k: int, num_segments: int,
              device: str | torch.device, chunk: int = 256) -> "TepLayout":
        """The layout of ``decoding_path``'s TEP blocks
        (:func:`build_tep_blocks`) on ``device``."""
        blocks, _ = build_tep_blocks(decoding_path, k, num_segments)
        return cls.from_blocks(blocks, device, chunk)

    @classmethod
    def from_blocks(cls, blocks: list[np.ndarray], device: str | torch.device,
                    chunk: int = 256) -> "TepLayout":
        """The layout of the TEP blocks ``blocks`` on ``device``."""
        teps, mask, bounds = pack_tep_chunks(blocks, chunk)
        acc = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
        block_of = np.full(mask.size, -1, np.int32)
        for p, (s, e) in enumerate(bounds):
            block_of[s:e] = p
        flat = torch.as_tensor(teps.reshape(-1, teps.shape[-1]))
        dev = torch.device(device)
        return cls(
            teps=torch.as_tensor(teps, device=dev),
            mask=torch.as_tensor(mask, device=dev), bounds=bounds,
            acc=torch.as_tensor(acc, dtype=torch.int64, device=dev),
            positions=tuple(t.to(dev) for t in osd_disc.tep_positions(flat)),
            block_of=torch.as_tensor(block_of, device=dev),
            starts=torch.as_tensor([s for s, _ in bounds], dtype=torch.int64,
                                   device=dev),
            ntot=int(acc[-1]))

    @property
    def flat(self) -> torch.Tensor:
        """The (C*chunk, k) int8 TEP rows (a view of ``teps``)."""
        return self.teps.view(-1, self.teps.shape[-1])
