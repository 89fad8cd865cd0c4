"""The least time of a layer's work on one H100, from the call's shapes.

A frozen copy of the bound arithmetic of the port's chip checks
(``chip_smoke.py``): it counts what the function needs, whatever
implements it, against the data-sheet peaks of an H100 SXM at its 700 W
limit.  The least time is the larger of the compulsory bytes over the HBM
rate and the busiest unit's operations over its rate (the units run
concurrently).
"""

from __future__ import annotations

HBM_BPS = 3.35e12  # HBM3 bytes/s
# f32 instructions/s outside the tensor cores: 67 TFLOP/s counts an FMA as
# two FLOPs, so an add, compare, min or FMA issues at half that rate
F32_INSTR = 67e12 / 2
INT8_OPS = 1979e12  # int8 tensor-core OP/s
# 32-bit integer instructions/s: 64 INT32 lanes an SM against the 128 f32
# lanes behind the f32 rate
INT32_OPS = F32_INSTR / 2


def bound_s(nbytes: float, *unit_seconds: float) -> float:
    """Seconds: the larger of the bytes over the HBM rate and the busiest
    unit's time."""
    return max(nbytes / HBM_BPS, *unit_seconds)


def edge_ops(h, frame_iters: float, closings: float) -> float:
    """f32 instructions of an edge decode: per frame-iteration 8 per edge
    (column add, vc = total - cv, |vc|, the min/submin update (2), the sign
    parity, the magnitude select, the sign apply), 2 per check and 1 per
    variable; each closing column sum (one a decision) 1 per edge and 1 per
    variable."""
    m, n = h.shape
    edges = int(h.sum())
    return frame_iters * (8 * edges + 2 * m + n) + closings * (edges + n)


def nms_edge_ops(h, batch: int, iters: int) -> float:
    """f32 instructions of ``iters`` iterations on ``batch`` frames."""
    return edge_ops(h, batch * iters, batch)


def ge_bound_s(b: int, m: int, n: int, k: int, load: str = "perm") -> float:
    """GF(2) elimination: the permutation in (int64; or the dense batch,
    int8), the int8 tail and the int32 order out, against B m^2 ceil(n/32)
    word XORs on the INT32 lanes."""
    nin = 8 * b * n if load == "perm" else b * m * n
    return bound_s(nin + b * m * k + 4 * b * n, b * m * m * -(-n // 32) / INT32_OPS)


def k5_bound_s(b: int, m: int, k: int, ntot: int) -> float:
    """TEP discrepancy parity term: 2 B m k N binary MACs on the int8
    tensor cores, one f32 FMA a (frame, row, TEP), M, u_l and T in and the
    (B, N) f32 result out."""
    nbytes = b * m * k + 4 * b * m + ntot * k + 4 * b * ntot
    return bound_s(nbytes, 2.0 * b * m * k * ntot / INT8_OPS,
                   1.0 * b * m * ntot / F32_INSTR)


def capture_bound_s(h, batch: int, iters: int, cap: int) -> float:
    """The capture step: the decode's f32 instructions against the captured
    rows (f32 LLR and int32 word) and the five int64 counters out."""
    n = h.shape[1]
    return bound_s(8 * cap * n + 8 * 5, nms_edge_ops(h, batch, iters) / F32_INSTR)


def compact_bound_s(h, frame_iters: float, closings: float) -> float:
    """A fused Monte-Carlo step: its edge decode's f32 instructions (the
    frames sample and encode in registers) against six int64 counters out."""
    return bound_s(8 * 6, edge_ops(h, frame_iters, closings) / F32_INSTR)
