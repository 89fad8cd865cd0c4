"""The fused Monte-Carlo rungs of ``run_nms_mc``: their order, the pinned
rung, and the compaction group.

Port of ``short_ldpc_decoding_osd_tpu/mc/ladder.py``.  The JAX ladder walks
the rungs in :data:`RUNGS` order and demotes to the next one when a kernel
fails to compile or fit VMEM (``build_ladder_step``, ``attempt_multiproc``).
The port has no demotion: a kernel that fails to build or launch fails the
run, and a caller reaches a later rung by naming it (``run_nms_mc(rung=)``,
the counterpart of ``apply_pinned_rung``).  What the ladder holds as
semantics stays: a compact step that overflowed is redone one-shot, and the
sweep stays one-shot (overflowed frames are judged at t1, which would bias
the FER upward if kept).
"""

from __future__ import annotations

# compact edge kernel K3 -> one-shot edge kernel K4 -> dense kernel K7 ->
# plain step (the dense decoder, ``build_nms_mc_step(decoder="plain")``)
RUNGS = ("compact", "oneshot", "dense", "xla")


def apply_pinned_rung(pinned: str | None) -> str | None:
    """The rung a caller pins, or None for the default order; raises on an
    unknown name."""
    if pinned in (None, ""):
        return None
    if pinned not in RUNGS:
        raise ValueError(f"unknown rung {pinned!r}; expected "
                         + "|".join(RUNGS))
    return pinned


def ladder_blocks(batch: int, num_iterations: int, t1: int = 4):
    """(cblock, compact_enabled): the compaction group of the compact rung,
    512 frames (what the JAX ladder derives for CCSDS) halved until it
    divides ``batch``, and whether compaction applies (a group of at least
    128 frames and at least two iterations left after t1)."""
    cblock = 512
    while cblock >= 8 and batch % cblock:
        cblock //= 2
    compact_enabled = num_iterations > t1 + 1 and cblock >= 128
    return cblock, compact_enabled
