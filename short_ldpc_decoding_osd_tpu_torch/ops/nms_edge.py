"""Edge-layout NMS decode and fused Monte-Carlo counters: wrappers over
the CUDA kernels K1, K2, K3 and K4.

Port of ``short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py``
(``decode_final_edge`` :339 over ``_decode_kernel`` :330,
``decode_traj_edge`` :421 over ``_decode_traj_kernel`` :406,
``fused_counters_edge`` :628 over ``_mc_kernel`` :497 and
``fused_counters_edge_compact`` :894 over ``_mc_schedule_kernel`` :691,
with ``build_rows_schedule`` :869).  K1/K2 live in ``csrc/nms_edge.cu``,
K3/K4 in ``csrc/mc_fused.cu``; the plain PyTorch twins here repeat their
arithmetic step for step (same edge order, same tournament, same summation
order), so on the card kernel and twin agree to the last bit or close to it.

A wrapper runs the twin only when ``llr`` lies on the CPU; for a CUDA tensor
it launches the kernel or raises.  The scalar-normalized variants
(NMS-1/2/3, ENMS) run K1/K2; NMS-r's neural check update has decode
kernels of its own (the same entry points, ``nms_edge_decode_nmsr``) on a
regular check degree that bucket 0 takes (:func:`kernel_holds`), and
raises elsewhere, where JAX raises everywhere.  Every kernel
runs one iteration body (``csrc/nms_edge_body.cuh``) whose degree bucket
and launch shape the host picks (:func:`launch_plan`); a code no bucket
takes raises.  At the split bucket (checks of degree 21 to 40) a check of
degree above 20 spans two lanes, placed by a lane map the host builds once
(:func:`split_map`, a ``codes.tables`` item); such a launch counts its
frames in ``split.frames``.  K3's launches after the first resume their
frames from the messages the previous launch saved, as the TPU kernel
carries its compacted rows' messages; the twins take the same route.

Layout: check-centric edges numbered slab-major, ``e = j*m + c`` for slot
``j`` of check ``c``.  Irregular rows pad with dummy edges (``edge_col < 0``)
that the kernel skips.  The TPU kernel's one-hot incidence matmuls, bf16
hi/lo split, lane packing and VMEM block model are MXU/VMEM artifacts and
have no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from .._device import resolve_device
from ..channel.awgn import sigma_for_snr
from ..codes import tables
from ..utils import profiling
from . import mc_hash
from .nms import _weights, frame_stats, scalar_weights


def edge_layout(h):
    """Edge tables of ``h``: ``edge_col`` (dc, m) int32, the variable of
    slot j of check c (-1 for a dummy edge), and ``var_edges`` (dv, n)
    int32, the edges of variable v in ascending check order (-1 padded)."""
    h = np.asarray(h, dtype=np.uint8)
    m, n = h.shape
    degrees = h.sum(axis=1)
    if degrees.min() < 2:
        # a degree-1 check has no extrinsic message (and no second operand
        # for the min/submin tournament)
        raise ValueError(
            f"edge kernels need every check degree >= 2, got {int(degrees.min())}"
        )
    dc = int(degrees.max())
    edge_col = np.full((dc, m), -1, np.int32)
    for c in range(m):
        cols = np.flatnonzero(h[c])
        edge_col[: len(cols), c] = cols
    dv = int(h.sum(axis=0).max())
    var_edges = np.full((dv, n), -1, np.int32)
    for v in range(n):
        checks = np.flatnonzero(h[:, v])  # ascending check order
        slots = [int(np.flatnonzero(edge_col[:, c] == v)[0]) for c in checks]
        var_edges[: len(checks), v] = [j * m + c for j, c in zip(slots, checks)]
    return edge_col, var_edges


# The compile-time buckets of the iteration body (csrc/nms_edge_body.cuh,
# Bucket0..Bucket4): (largest check degree, largest variable degree, checks
# a lane owns, variables a lane owns).  The packaged codes take buckets 0-2,
# the extended matrices of ENMS buckets 3 and 4.
BUCKETS = ((8, 6, 2, 4), (11, 6, 2, 4), (20, 6, 1, 4), (12, 64, 2, 1),
           (40, 6, 1, 4))
# The split bucket: a lane keeps one segment of SPLIT_SLOTS slots, so a
# check of degree above that spans two lanes (:func:`split_map`)
SPLIT_BUCKET = 4
SPLIT_SLOTS = 20
# warps of one frame and of one block (csrc/nms_edge_body.cuh kMaxWarps,
# kMaxThreads / 32); a block holds max(1, 4 // warps) frames
_MAX_WARPS = 16
_BLOCK_WARPS = 4
MAX_LANES = 32 * _MAX_WARPS  # kMaxThreads: the lane map's lane entries
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a Hopper block can use


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernels over the iteration body lay out one code: the
    degree bucket, the warps of one frame (lane t of the frame's 32 * warps
    owns checks t + T q and variables t + T i) and the frames of a block."""

    bucket: int
    warps: int
    frames: int


def region_words(bucket: int, threads: int, extra: int = 0) -> int:
    """Shared words of one frame of ``threads`` lanes (``region_words`` of
    csrc/nms_edge_body.cuh): the column totals and the +inf word, one
    message row of ``slots | 1`` words per owned check (a lane's segment at
    the split bucket, :data:`SPLIT_SLOTS` slots; else ``dc`` slots) and the
    zero word, and ``extra`` words of the kernel."""
    dc, _, cpl, vpl = BUCKETS[bucket]
    slots = SPLIT_SLOTS if bucket == SPLIT_BUCKET else dc
    return vpl * threads + 1 + cpl * threads * (slots | 1) + 1 + extra


def split_lanes(h) -> int:
    """The lanes the checks of ``h`` take at the split bucket: one a
    check, two a check of degree above :data:`SPLIT_SLOTS`."""
    return tables.get(h, _split_lanes)


def _split_lanes(host, device):
    del device
    degrees = host.sum(axis=1)
    return len(degrees) + int((degrees > SPLIT_SLOTS).sum())


def split_map(h) -> np.ndarray:
    """The split bucket's lane map of ``h`` (m, n), int32 (MAX_LANES + m,):
    entry ``l`` is ``2 c + s`` for the lane that owns segment ``s`` of check
    ``c`` (its slots ``SPLIT_SLOTS s ..``), -1 for a lane that owns none;
    entry ``MAX_LANES + c`` is check c's first lane.  The checks of degree
    above :data:`SPLIT_SLOTS` come first, each on an even lane and the next
    (one warp), then the others, each in check order; so no lane is left
    out.  ``csrc/nms_dense.cu``'s ``build_split`` makes the same map on the
    card."""
    degrees = np.asarray(h, dtype=np.int64).sum(axis=1)
    m = len(degrees)
    wide = np.flatnonzero(degrees > SPLIT_SLOTS)
    whole = np.flatnonzero(degrees <= SPLIT_SLOTS)
    if 2 * len(wide) + len(whole) > MAX_LANES:
        raise ValueError(f"{m} checks need more than {MAX_LANES} lanes")
    first = np.empty(m, np.int32)
    first[wide] = 2 * np.arange(len(wide))
    first[whole] = 2 * len(wide) + np.arange(len(whole))
    lanes = np.full(MAX_LANES, -1, np.int32)
    lanes[first[wide]] = 2 * wide
    lanes[first[wide] + 1] = 2 * wide + 1
    lanes[first[whole]] = 2 * whole
    return np.concatenate([lanes, first])


def _split_tables(host, device):
    """:func:`split_map` as an int32 tensor on ``device`` (a
    ``codes.tables`` item)."""
    return torch.tensor(split_map(host), device=device)


def launch_plan(m: int, n: int, dc: int, dv: int, extra_words: int = 0,
                table_words: int = 0, lanes: int | None = None
                ) -> LaunchPlan | None:
    """The launch plan of an (m, n) code of largest degrees (dc, dv): the
    first bucket that takes the degrees, the fewest warps whose lanes own
    every check (at the split bucket, ``lanes`` of them: :func:`split_lanes`;
    by default two a check) and variable, ``max(1, 4 // warps)`` frames a
    block; None when no bucket takes the degrees, a frame would need more
    than 16 warps or a block (``table_words`` once, ``extra_words`` a
    frame) exceeds the 227 KB of shared memory a block can use."""
    for bucket, (bdc, bdv, cpl, vpl) in enumerate(BUCKETS):
        if dc > bdc or dv > bdv:
            continue
        if bucket == SPLIT_BUCKET:
            owners = 2 * m if lanes is None else lanes
        else:
            owners = -(-m // cpl)
        warps = max(1, -(-owners // 32), -(-n // (32 * vpl)))
        if warps > _MAX_WARPS:
            return None
        frames = max(1, _BLOCK_WARPS // warps)
        words = region_words(bucket, 32 * warps, extra_words)
        if 4 * (table_words + frames * words) > SMEM_LIMIT:
            return None
        return LaunchPlan(bucket, warps, frames)
    return None


# the bucket NMS-r's kernels are built for: its sorting network of 8 slots
# and its (dc-1) x 4 weights by value take a regular check degree up to 8
NMSR_BUCKET = 0


def kernel_holds(h, variant: str = "NMS-1") -> bool:
    """True when the edge kernels take ``h`` for ``variant``: every check
    has degree >= 2 and a launch plan holds the code (:func:`launch_plan`);
    for NMS-r also a regular check degree and the plan's bucket
    :data:`NMSR_BUCKET`."""
    degrees = np.asarray(h, dtype=np.int64).sum(axis=1)
    if degrees.min() < 2:
        return False
    plan = matrix_plan(h)
    if variant == "NMS-r":
        return (plan is not None and plan.bucket == NMSR_BUCKET
                and bool((degrees == degrees[0]).all()))
    return plan is not None


def matrix_plan(h, extra_words: int = 0, table_words: int = 0
                ) -> LaunchPlan | None:
    """:func:`launch_plan` of the matrix ``h``: its shape, its largest
    degrees and the lanes its checks take at the split bucket."""
    return launch_plan(*np.shape(h), *tables.degrees(h), extra_words,
                       table_words, split_lanes(h))


def split_operand(h, plan: LaunchPlan, device):
    """The kernels' lane-map operand for ``plan`` on ``h``: the
    :func:`split_map` tensor on ``device`` at the split bucket, else None
    (the kernels refuse a map anywhere else)."""
    if plan.bucket != SPLIT_BUCKET:
        return None
    return tables.get(h, _split_tables, device)


def _edge_tables(h, device):
    """:func:`edge_layout` as int32 tensors on ``device`` (a
    ``codes.tables`` item)."""
    return tuple(torch.tensor(a, device=device) for a in edge_layout(h))


def _iterate_plain(llr, h, num_iterations, w_vc, w_marg, traj, check,
                   cv0=None):
    """The twins' iteration (the kernels' order): each variable sums its
    messages in ascending check order, ``total = colsum + w_vc * llr``,
    each edge's ``vc = total - cv`` (B, dc, m) goes through ``check`` to
    the new messages, and the soft outputs are ``colsum + w_marg * llr``.
    ``cv0`` (B, dc*m), e = j*m + c: the messages to resume from (default
    zero).  Returns (the (T+1, B, n) trajectory or the last soft output,
    the messages after the last iteration)."""
    edge_col, var_edges = tables.get(h, _edge_tables, llr.device)
    dc, m = edge_col.shape
    batch, n = llr.shape
    num_edges = dc * m
    cols = edge_col.clamp(min=0).long()
    # padded variable slots read a message slot that stays zero
    var_idx = torch.where(var_edges >= 0, var_edges, num_edges).long()
    cv = torch.zeros(batch, num_edges + 1, dtype=torch.float32, device=llr.device)
    if cv0 is not None:
        cv[:, :num_edges] = cv0
    outs = [llr] if traj else []
    soft = None
    for it in range(num_iterations + 1):
        s = torch.zeros(batch, n, dtype=torch.float32, device=llr.device)
        for d in range(var_idx.shape[0]):
            s = s + cv[:, var_idx[d]]
        if it > 0 and (traj or it == num_iterations):
            soft = s + w_marg * llr
            if traj:
                outs.append(soft)
        if it == num_iterations:
            break
        total = s + w_vc * llr
        vc = total[:, cols] - cv[:, :num_edges].view(batch, dc, m)
        cv[:, :num_edges] = check(vc).reshape(batch, num_edges)
    if traj:
        out = torch.stack(outs, 0)
    elif soft is not None:
        out = soft
    else:  # zero iterations: the column sums of the initial messages
        out = w_marg * llr if cv0 is None else s + w_marg * llr
    return out, cv[:, :num_edges]


def _decode_edge_plain(llr, h, num_iterations, weights, traj, cv0=None,
                       return_cv=False):
    """Plain PyTorch twin of ``csrc/nms_edge.cu`` (same operation order).
    ``cv0`` (B, dc*m), e = j*m + c: the check-to-variable messages to
    resume from (default zero); ``return_cv`` also returns the messages
    after the last iteration, so that a decode resumed from them runs on
    exactly as an uninterrupted one."""
    w_vc, w_chk, w_marg = weights
    valid = tables.get(h, _edge_tables, llr.device)[0] >= 0

    def tournament(vc):
        batch, dc, m = vc.shape
        mag = torch.where(valid, vc.abs(), torch.inf)
        sgn = torch.where(vc > 0, 1.0, torch.where(vc < 0, -1.0, 0.0))
        sgn = torch.where(valid, sgn, 1.0)
        min1 = torch.full((batch, m), torch.inf, device=vc.device)
        min2 = torch.full((batch, m), torch.inf, device=vc.device)
        sign_prod = torch.ones((batch, m), device=vc.device)
        for j in range(dc):
            min2 = torch.minimum(min2, torch.maximum(min1, mag[:, j]))
            min1 = torch.minimum(min1, mag[:, j])
            sign_prod = sign_prod * sgn[:, j]
        emag = torch.where(mag > min1[:, None], (w_chk * min1)[:, None],
                           (w_chk * min2)[:, None])
        return torch.where(valid, emag * (sign_prod[:, None] * sgn), 0.0)

    out, cv = _iterate_plain(llr, h, num_iterations, w_vc, w_marg, traj,
                             tournament, cv0)
    return (out, cv) if return_cv else out


def _kernel_tables(llr, h):
    """The edge tables of ``h`` on ``llr``'s device and the launch plan
    of the edge kernels, after checking ``llr`` against them."""
    if llr.dtype != torch.float32 or llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous (B, n) float32 tensor")
    edge_col, var_edges = tables.get(h, _edge_tables, llr.device)
    dc, m = edge_col.shape
    dv, n = var_edges.shape
    if llr.shape[1] != n:
        raise ValueError(f"llr has {llr.shape[1]} columns, h has {n}")
    plan = matrix_plan(h)
    if plan is None:
        raise ValueError(f"no launch plan of the edge kernels holds an ({m}, "
                         f"{n}) code of degrees ({dc}, {dv})")
    if llr.shape[0] >= 2**31:
        raise ValueError(f"batch {llr.shape[0]} exceeds the kernel's int32 count")
    return edge_col, var_edges, plan


def count_split(plan: LaunchPlan, frames: int) -> None:
    """``split.frames``: the frames or slots of a launch that succeeded at
    the split bucket."""
    if plan.bucket == SPLIT_BUCKET:
        profiling.count("split.frames", frames)


def _decode_edge_kernel(llr, h, num_iterations, weights, traj,
                        extended=False):
    """Launch ``nms_edge_decode`` (K1, or K2 with ``traj``); with
    ``extended`` (ENMS's matrix) counts the frames decoded after a launch
    that succeeded, ``enms.frames``, and at the split bucket
    ``split.frames``."""
    edge_col, var_edges, plan = _kernel_tables(llr, h)
    (dc, m), (dv, n), batch = edge_col.shape, var_edges.shape, llr.shape[0]
    if num_iterations == 0 and not traj:
        return weights[2] * llr
    shape = (num_iterations + 1, batch, n) if traj else (batch, n)
    out = torch.empty(shape, dtype=torch.float32, device=llr.device)
    split = split_operand(h, plan, llr.device)
    lib = _kernels.library("nms_edge")
    status = lib.nms_edge_decode(
        llr.data_ptr(), out.data_ptr(), edge_col.data_ptr(),
        var_edges.data_ptr(), None if split is None else split.data_ptr(),
        batch, n, m, dc, dv, num_iterations, *weights, int(traj),
        plan.bucket, plan.warps, plan.frames, split_lanes(h),
        _kernels.stream_handle(llr.device),
    )
    _kernels.check(status, "nms_edge_decode")
    _kernels.LAUNCHES["nms_edge_traj" if traj else "nms_edge_final"] += 1
    if extended:
        profiling.count("enms.frames", batch)
    count_split(plan, batch)
    return out


def nmsr_weights(params: dict) -> tuple:
    """NMS-r's kernel operands as host values: ``(w_vc, w_marg, w1, w2)``,
    the bit scalars' softplus as floats and the network's (dc-1, 4) and
    (4, 1) weights as f32 arrays (host parameters: no device read)."""
    w_vc, _, w_marg = _weights(params, "NMS-r")
    w1, w2 = (np.asarray(torch.as_tensor(params[k]).detach().cpu(), np.float32)
              for k in ("nn_w1", "nn_w2"))
    return float(w_vc), float(w_marg), w1, w2


def _network_by_position(a, w1, w2):
    """(B, dc, m) magnitudes of NMS-r's network for each sorted position r
    of the rows' ascending magnitudes ``a`` (B, dc, m): over the list ``a``
    less entry r, ``(x @ w1) @ w2`` with each sum in ascending index order,
    as the kernel computes it (the products s[i] w1[i] before r and
    s[i] w1[i-1] after it, the sums over the first r entries shared)."""
    dc = a.shape[1]
    out = None
    for j in range(w1.shape[1]):
        lo = [a[:, i] * w1[i, j] for i in range(dc - 1)]
        hi = [None] + [a[:, i] * w1[i - 1, j] for i in range(1, dc)]
        hidden, head = [], None
        for r in range(dc):
            if r == 0:
                h = hi[1]
            else:
                head = lo[0] if r == 1 else head + lo[r - 1]
                h = head
            for i in range(max(r + 1, 2), dc):
                h = h + hi[i]
            hidden.append(h)
        term = torch.stack(hidden, 1) * w2[j, 0]
        out = term if out is None else out + term
    return out


def _decode_nmsr_plain(llr, h, num_iterations, weights, traj):
    """Plain PyTorch twin of NMS-r's kernels (``nmsr_edge_kernel``): the
    iteration of :func:`_iterate_plain` with, per row, one ascending sort
    of the magnitudes carrying each slot, :func:`_network_by_position`,
    each position's magnitude back to its slot, its sign the parity of the
    other edges' sign bits, and a zero magnitude zeroing the row.  The
    kernel's rows of a code of degree dc < 8 carry dummy slots that add +0
    to its sums; the twin has none, and the same values."""
    w_vc, w_marg, w1, w2 = weights
    w1 = torch.as_tensor(w1, device=llr.device)
    w2 = torch.as_tensor(w2, device=llr.device)

    def neural(vc):
        a, slot = torch.sort(vc.abs(), dim=1)
        mag = torch.empty_like(a).scatter_(1, slot, _network_by_position(a, w1, w2))
        neg = torch.signbit(vc)
        flip = neg ^ (neg.sum(1, keepdim=True) % 2 == 1)
        return torch.where(a[:, :1] == 0, 0.0, torch.where(flip, -mag, mag))

    return _iterate_plain(llr, h, num_iterations, w_vc, w_marg, traj, neural)[0]


def _decode_nmsr_kernel(llr, h, num_iterations, weights, traj):
    """Launch ``nms_edge_decode_nmsr`` (``weights`` as :func:`_decode`
    checked them: the entry reads 6 + 4 (dc - 1) host values); counts the
    frames decoded after a launch that succeeded, ``nmsr.kernel_frames``."""
    edge_col, var_edges, plan = _kernel_tables(llr, h)
    (dc, m), (dv, n), batch = edge_col.shape, var_edges.shape, llr.shape[0]
    w_vc, w_marg, w1, w2 = weights
    if num_iterations == 0 and not traj:
        return w_marg * llr
    shape = (num_iterations + 1, batch, n) if traj else (batch, n)
    out = torch.empty(shape, dtype=torch.float32, device=llr.device)
    host = np.concatenate([[w_vc, w_marg], w2.ravel(), w1.ravel()]).astype(np.float32)
    status = _kernels.library("nms_edge").nms_edge_decode_nmsr(
        llr.data_ptr(), out.data_ptr(), edge_col.data_ptr(),
        var_edges.data_ptr(), batch, n, m, dc, dv, num_iterations,
        host.ctypes.data, int(traj), plan.bucket, plan.warps, plan.frames,
        _kernels.stream_handle(llr.device))
    _kernels.check(status, "nms_edge_decode_nmsr")
    _kernels.LAUNCHES["nmsr_edge_traj" if traj else "nmsr_edge_final"] += 1
    profiling.count("nmsr.kernel_frames", batch)
    return out


def _decode(params, h, llr, num_iterations, variant, traj):
    if variant == "NMS-r":
        if not kernel_holds(h, variant):
            raise ValueError("NMS-r's edge kernels take a regular check degree "
                             f"of 2 to 8 (bucket {NMSR_BUCKET}); not this "
                             f"{tuple(np.shape(h))} code")
        weights = nmsr_weights(params)
        dc = tables.degrees(h)[0]
        if weights[2].shape != (dc - 1, 4) or weights[3].shape != (4, 1):
            raise ValueError(f"NMS-r's network must be ({dc - 1}, 4) -> (4, 1), "
                             f"got {weights[2].shape} and {weights[3].shape}")
        plain, kernel = _decode_nmsr_plain, _decode_nmsr_kernel
    else:
        weights = scalar_weights(params, variant)
        plain = _decode_edge_plain
        kernel = functools.partial(_decode_edge_kernel,
                                   extended=variant == "ENMS")
    if llr.device.type == "cpu":
        return plain(llr, h, num_iterations, weights, traj)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return kernel(llr, h, num_iterations, weights, traj)


def decode_final_edge(params: dict, h, llr: torch.Tensor, num_iterations: int,
                      variant: str = "NMS-1") -> torch.Tensor:
    """Final-iteration soft outputs (B, n), ``colsum + w_marg * llr``
    (kernel K1 on CUDA; NMS-r its own kernel).  ``h`` is the host (m, n)
    0/1 parity matrix the decoder runs on (ENMS: ``Code.extended().h``)."""
    return _decode(params, h, llr, num_iterations, variant, traj=False)


def decode_traj_edge(params: dict, h, llr: torch.Tensor, num_iterations: int,
                     variant: str = "NMS-1") -> torch.Tensor:
    """Per-iteration soft-output trajectories (T+1, B, n) in the
    ``nms.decode`` convention: slot 0 = llr, slot t = colsum after t
    updates + w_marg * llr (kernel K2 on CUDA; NMS-r its own kernel).  Full
    f32 throughout, the JAX kernel's ``mode="highest"``."""
    return _decode(params, h, llr, num_iterations, variant, traj=True)


# ---------------------------------------------------------------------------
# Fused Monte-Carlo counters: K4 (one-shot) and K3 (convergence compaction)
#
# The frames come from the counter-based hash of ``ops/mc_hash.py``: frame i
# of a call with seed s is the same in K4, K3 and K8 (``ops/mc_cascade.py``),
# whatever the block sizes.  (The TPU kernels drew from the TPU's on-core
# PRNG, which has no counterpart here.)  Counter lanes:
# [frames, frame_err, bit_err, detected, undetected(, overflow)], int64.

# Default schedule (fraction of block_frames): 4 iterations on the full
# group, then the unconverged frames (~1/3 at the 3.0 dB flagship point) get
# a capacity of 208 of 512 rows, ~3.7 sigma above the mean; an overflowed
# step is redone one-shot by the Monte-Carlo harness.
DEFAULT_COMPACT_SCHEDULE = ((4, 0.40625),)
_LANES = 6
_MC_COUNT_WORDS = 16  # a block's 8 int64 counters (csrc/mc_fused.cu)
# frames per plain-twin chunk: bounds the twin's memory on the card
_PLAIN_CHUNK = 262_144


def build_rows_schedule(schedule, block_frames: int, num_iterations: int):
    """((iters, frac), ...) -> ((iters, rows), ...) truncated to the stages
    that leave at least one iteration after them.  Row capacities are
    ``int(block_frames * frac)`` rounded DOWN to a multiple of 8, floored at
    64 and capped at the previous stage's rows minus 8, so any (frac, block)
    pair yields a valid schedule or drops the stage.  Returns
    ``(rows_schedule, final_iters)``."""
    rows_schedule = []
    spent = 0
    rows_prev = block_frames
    for iters_i, frac in schedule:
        if spent + iters_i >= num_iterations:
            break  # not enough iterations left to be worth a stage
        rows = max(64, int(block_frames * frac)) // 8 * 8
        rows = min(rows, rows_prev - 8)
        if rows < 64:
            break  # capacity floor can't fit under the previous stage
        rows_schedule.append((iters_i, rows))
        rows_prev = rows
        spent += iters_i
    return tuple(rows_schedule), num_iterations - spent


def encode_tables(g) -> tuple[np.ndarray, np.ndarray]:
    """G's columns by kind, read from G: the kernels' encode operand.

    ``columns`` (n,) int32: for a column of weight 1, the index j of its
    message bit (the codeword bit is message bit j); for every other column
    (weight 0, or 2 and more) ``~p``, with p its column of ``parity``.
    ``parity`` (ceil(k/32), P) int32 over the P other columns in column
    order, word-major: bit b of word w of parity column p is
    ``G[32 w + b, v]`` for the v with ``columns[v] == ~p``, so that lanes
    that encode neighbouring columns read neighbouring words."""
    g = np.asarray(g, dtype=np.uint8)
    k, n = g.shape
    unit = g.sum(axis=0) == 1
    others = np.flatnonzero(~unit)
    columns = np.empty(n, np.int32)
    columns[unit] = g[:, unit].argmax(axis=0)
    columns[others] = ~np.arange(len(others), dtype=np.int32)
    kw = (k + 31) // 32
    padded = np.zeros((kw * 32, len(others)), np.uint64)
    padded[:k] = g[:, others]
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (padded.reshape(kw, 32, -1) * weights[None, :, None]).sum(axis=1)
    return columns, np.ascontiguousarray(words.astype(np.uint32).view(np.int32))


def encode_tensor(g, device):
    """:func:`encode_tables` as the kernels read them, one int32 tensor on
    ``device``: the n column kinds, then the parity words (a
    ``codes.tables`` item)."""
    columns, parity = encode_tables(g)
    return torch.tensor(np.concatenate([columns, parity.ravel()]),
                        device=device)


def parity_columns(encode: torch.Tensor, n: int, k: int) -> int:
    """P, the parity columns of an :func:`encode_tensor` of an (n, k) code."""
    return (encode.numel() - n) // ((k + 31) // 32)


@dataclasses.dataclass(frozen=True)
class MCSetup:
    """What every fused Monte-Carlo launch of one call shares: the tables
    of the matrix the decoder runs on and of the code's G on ``device``,
    the decoder weights, the channel (AWGN around a mean of 1) and the
    seed.  ENMS decodes on ``Code.extended().h``: H and the pairwise sums
    of its rows, so a word's syndrome on it is zero exactly when it is on
    H, and the counters keep their meaning."""

    h: np.ndarray  # (m, n) 0/1 matrix the decoder runs on (host)
    extended: bool  # h is ENMS's extended matrix
    k: int
    weights: tuple  # (w_vc, w_chk, w_marg) as f32 values
    sigma: float  # f32 value
    seed: int
    edge_col: torch.Tensor
    var_edges: torch.Tensor
    g32: torch.Tensor  # (k, n) float32, the plain twins' encode operand
    encode: torch.Tensor  # (n + ceil(k/32) P,) int32, the kernels'

    @property
    def device(self) -> torch.device:
        return self.edge_col.device

    @property
    def parity_columns(self) -> int:
        """P: G's columns that the kernels popcount (not of weight 1)."""
        return parity_columns(self.encode, self.h.shape[1], self.k)

    @property
    def plan(self) -> LaunchPlan | None:
        """The launch plan of ``mc_frames`` for this code (None: the
        kernels do not hold it)."""
        return mc_plan(self.h, self.k)


def mc_plan(h, k: int) -> LaunchPlan | None:
    """The launch plan of ``mc_frames`` (csrc/mc_fused.cu) on the matrix
    ``h``: a frame also keeps its ceil(k/32) message words and 2 flags, a
    block its 64 bytes of counters."""
    return matrix_plan(h, extra_words=(k + 31) // 32 + 2,
                       table_words=_MC_COUNT_WORDS)


def mc_setup(code, params: dict, variant: str, snr_db: float, seed: int,
             device: str | torch.device = "cuda") -> MCSetup:
    """The shared state of a fused Monte-Carlo call on ``device`` (plain
    AWGN at ``snr_db``): the edge tables of ``code.h``, or for ENMS of
    ``code.extended().h``; G, its encode tables and the sampler stay the
    code's.  The tables come from ``codes.tables``."""
    dev = resolve_device(device)
    extended = variant == "ENMS"
    h = code.extended().h if extended else code.h
    edge_col, var_edges = tables.get(h, _edge_tables, dev)
    return MCSetup(
        h=h, extended=extended, k=code.g.shape[0],
        weights=scalar_weights(params, variant),
        sigma=float(np.float32(sigma_for_snr(snr_db, code.rate))),
        seed=int(seed) & 0xFFFFFFFF, edge_col=edge_col, var_edges=var_edges,
        g32=tables.f32(code.g, dev),
        encode=tables.get(code.g, encode_tensor, dev))


def _frame_errors(mc: MCSetup, soft: torch.Tensor, codeword: torch.Tensor):
    """Per frame: bit errors (int64) and a nonzero syndrome (bool) of the
    hard decision ``soft < 0`` (``nms.frame_stats``'s rule)."""
    st = frame_stats(soft, codeword, mc.h)
    return st["bit_errors"].to(torch.int64), st["detected_failure"]


def _count(bit_err, unconv, judged) -> torch.Tensor:
    """Counter lanes over the ``judged`` frames (overflow lane 0)."""
    fe = (bit_err > 0) & judged
    return torch.stack([
        judged.sum(), fe.sum(), torch.where(judged, bit_err, 0).sum(),
        (unconv & judged).sum(), (fe & ~unconv).sum(),
        torch.zeros((), dtype=torch.int64, device=bit_err.device)])


def _mc_frames_plain(mc: MCSetup, iters: int, count: int, ids=None,
                     stage: bool = False, msgs_in=None, src=None,
                     keep: bool = False):
    """Plain twin of ``mc_frames_kernel`` (csrc/mc_fused.cu): slots
    ``0..count-1`` hold frames ``0..count-1``, or ``ids`` (int32, -1 =
    padding).  A slot starts from zero messages or, given ``msgs_in``
    (rows, dc*m) and ``src`` (count,) int32, from row ``src[i]`` (a resumed
    frame), and runs ``iters`` iterations.  Returns the (6,) counters, for a
    stage launch the per-slot stat (0 for a converged frame or padding,
    else ``1 | bit_errors << 1``), and with ``keep`` (a stage launch) the
    (count, dc*m) messages of the unconverged slots (other rows unset)."""
    total = torch.zeros(_LANES, dtype=torch.int64, device=mc.device)
    stats = []
    msgs_out = (torch.zeros((count, mc.edge_col.numel()), dtype=torch.float32,
                            device=mc.device) if keep else None)
    for start in range(0, count, _PLAIN_CHUNK):
        stop = min(count, start + _PLAIN_CHUNK)
        if ids is None:
            fid = torch.arange(start, stop, dtype=torch.int64, device=mc.device)
        else:
            fid = ids[start:stop].to(torch.int64)
        valid = fid >= 0
        codeword, llr = mc_hash.sample(fid.clamp(min=0), mc.seed, mc.g32,
                                       mc.sigma)
        cv0 = None
        if msgs_in is not None:
            cv0 = msgs_in[src[start:stop].to(torch.int64).clamp(min=0)]
        soft, cv = _decode_edge_plain(llr, mc.h, iters, mc.weights, traj=False,
                                      cv0=cv0, return_cv=True)
        bit_err, unconv = _frame_errors(mc, soft, codeword)
        if stage:
            total += _count(bit_err, unconv, valid & ~unconv)
            stats.append(torch.where(valid & unconv, 1 | (bit_err << 1), 0)
                         .to(torch.int32))
            if keep:
                saved = valid & unconv
                msgs_out[start:stop][saved] = cv[saved]
        else:
            total += _count(bit_err, unconv, valid)
    if not stage:
        return total, None, None
    if not stats:
        return total, torch.zeros(0, dtype=torch.int32, device=mc.device), msgs_out
    return total, torch.cat(stats), msgs_out


@functools.lru_cache(maxsize=32)
def mc_occupancy(plan: LaunchPlan, k: int, stage: bool, table_words: int,
                 device_index: int) -> dict:
    """The launch shape of ``mc_frames`` on the card: resident blocks per
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spilled) bytes per thread, shared bytes and threads per block,
    SMs, and whether G's encode tables (``table_words``) go to shared
    memory: where they cost no resident block.  ``device_index`` keys the
    cache (the query runs on the current device)."""
    del device_index
    out = (ctypes.c_int * 7)()
    status = _kernels.library("mc_fused").mc_frames_occupancy(
        plan.bucket, plan.warps, plan.frames, k, int(stage), table_words,
        ctypes.addressof(out))
    _kernels.check(status, "mc_frames_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes", "threads", "sms", "table_shared"), out))


def _check_i32(name, t, count, device):
    if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
            or len(t) != count or t.device != device):
        raise ValueError(f"{name} must be a contiguous (count,) int32 tensor "
                         "on the tables' device")


def _mc_frames_kernel(mc: MCSetup, iters: int, count: int, ids=None,
                      stage: bool = False, msgs_in=None, src=None,
                      keep: bool = False):
    """Launch ``mc_frames`` (csrc/mc_fused.cu); same contract as
    :func:`_mc_frames_plain`.  Counts G's columns of each kind, once a
    launch: ``mc.columns_as_bit`` (unit columns, read as a message bit) and
    ``mc.columns_encoded`` (the others, popcounted); on ENMS's extended
    matrix also the launch's ``count`` slots, ``enms.frames``, and at the
    split bucket ``split.frames``."""
    if ids is not None:
        _check_i32("ids", ids, count, mc.device)
    if (msgs_in is None) != (src is None) or (keep and not stage):
        raise ValueError("msgs_in and src go together; keep needs stage")
    num_edges = mc.edge_col.numel()
    if msgs_in is not None:
        _check_i32("src", src, count, mc.device)
        if (msgs_in.dtype != torch.float32 or msgs_in.dim() != 2
                or msgs_in.shape[1] != num_edges or not msgs_in.is_contiguous()
                or msgs_in.device != mc.device):
            raise ValueError(f"msgs_in must be a contiguous (rows, {num_edges}) "
                             "float32 tensor on the tables' device")
    if count >= 2**31:
        raise ValueError(f"count {count} exceeds the kernel's int32 frame ids")
    plan = mc.plan
    if plan is None:
        raise ValueError(f"no launch plan of mc_frames holds the "
                         f"{mc.h.shape} code")
    occ = mc_occupancy(plan, mc.k, stage, mc.encode.numel(),
                       mc.device.index or 0)
    grid = min(-(-count // plan.frames), occ["blocks_per_sm"] * occ["sms"])
    lib = _kernels.library("mc_fused")
    dc, m = mc.edge_col.shape
    dv, n = mc.var_edges.shape
    counters = torch.zeros(_LANES, dtype=torch.int64, device=mc.device)
    stat = (torch.empty(count, dtype=torch.int32, device=mc.device)
            if stage else None)
    msgs_out = (torch.empty((count, num_edges), dtype=torch.float32,
                            device=mc.device) if keep else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    p = mc.parity_columns
    split = split_operand(mc.h, plan, mc.device)
    status = lib.mc_frames(
        ptr(ids), ptr(src), ptr(msgs_in), ptr(msgs_out), ptr(stat),
        counters.data_ptr(), mc.edge_col.data_ptr(), mc.var_edges.data_ptr(),
        ptr(split), mc.encode.data_ptr(), count, n, m, dc, dv, mc.k, p, iters,
        plan.bucket, plan.warps, plan.frames, split_lanes(mc.h), grid,
        occ["table_shared"], mc.seed, mc.sigma, 1.0, *mc.weights,
        _kernels.stream_handle(mc.device))
    _kernels.check(status, "mc_frames")
    profiling.count("mc.columns_as_bit", n - p)
    profiling.count("mc.columns_encoded", p)
    if mc.extended:
        profiling.count("enms.frames", count)
    count_split(plan, count)
    return counters, stat, msgs_out


def _group_rank_plain(stat, ids_in, groups: int, group_size: int,
                      rows_next: int):
    """Plain twin of ``group_rank_kernel``: per group, the unconverged slots
    ranked in frame order; the first ``rows_next`` go to the next id list
    with their slot (-1 padded), the rest count as overflow judged at this
    stage.  Returns (counters, ids_out, src_out)."""
    s = stat.view(groups, group_size)
    u = s != 0
    rank = torch.cumsum(u, 1) - u.to(torch.int64)
    covered = u & (rank < rows_next)
    over = u & ~covered
    be = (s >> 1).to(torch.int64)
    n_over = over.sum()
    zero = torch.zeros((), dtype=torch.int64, device=stat.device)
    counters = torch.stack([n_over, (over & (be > 0)).sum(),
                            torch.where(over, be, 0).sum(), n_over, zero, n_over])
    slots = torch.arange(groups * group_size, dtype=torch.int32,
                         device=stat.device).view(groups, group_size)
    fid = slots if ids_in is None else ids_in.view(groups, group_size)
    ids_out = torch.full((groups, rows_next), -1, dtype=torch.int32,
                         device=stat.device)
    src_out = torch.full_like(ids_out, -1)
    g_idx, pos = covered.nonzero(as_tuple=True)
    ids_out[g_idx, rank[g_idx, pos]] = fid[g_idx, pos]
    src_out[g_idx, rank[g_idx, pos]] = slots[g_idx, pos]
    return counters, ids_out.view(-1), src_out.view(-1)


def _group_rank_kernel(stat, ids_in, groups: int, group_size: int,
                       rows_next: int):
    """Launch ``mc_group_rank`` (csrc/mc_fused.cu); same contract as
    :func:`_group_rank_plain`."""
    lib = _kernels.library("mc_fused")
    ids_out = torch.empty(groups * rows_next, dtype=torch.int32,
                          device=stat.device)
    src_out = torch.empty_like(ids_out)
    partials = torch.empty((groups, _LANES), dtype=torch.int32,
                           device=stat.device)
    status = lib.mc_group_rank(
        stat.data_ptr(), None if ids_in is None else ids_in.data_ptr(),
        ids_out.data_ptr(), src_out.data_ptr(), partials.data_ptr(), groups,
        group_size, rows_next, _kernels.stream_handle(stat.device))
    _kernels.check(status, "mc_group_rank")
    return partials.sum(0, dtype=torch.int64), ids_out, src_out


def _compact_chain(mc: MCSetup, batch: int, block_frames: int, rows_schedule,
                   final_iters: int, frames_fn=_mc_frames_kernel,
                   rank_fn=_group_rank_kernel) -> torch.Tensor:
    """K3 as a chain of launches: per stage, the alive frames run the
    stage's iterations (STAGE launch: from scratch at the first stage,
    resumed from the previous stage's saved messages after it; it banks the
    converged frames and saves the messages of the others), then each
    group's unconverged frames are ranked and the first ``rows`` go on with
    their source slot; the last list runs the remaining ``final_iters``
    iterations, resumed (COUNT launch).  Each frame thus decodes each
    iteration once, as in the TPU kernel.  ``frames_fn``/``rank_fn`` are
    the kernel launchers on the card; the tests hand in the plain twins."""
    total = torch.zeros(_LANES, dtype=torch.int64, device=mc.device)
    groups = batch // block_frames
    ids, src, msgs, group, count = None, None, None, block_frames, batch
    for iters_i, rows_i in rows_schedule:
        counters, stat, saved = frames_fn(mc, iters_i, count, ids, stage=True,
                                          msgs_in=msgs, src=src, keep=True)
        total += counters
        counters, ids, src = rank_fn(stat, ids, groups, group, rows_i)
        total += counters
        msgs, group, count = saved, rows_i, groups * rows_i
    counters, _, _ = frames_fn(mc, final_iters, count, ids, msgs_in=msgs,
                               src=src)
    return total + counters


def _compact_plain(mc: MCSetup, batch: int, block_frames: int, rows_schedule,
                   final_iters: int) -> torch.Tensor:
    """The compaction rule computed literally (plain twin of K3): a frame
    is judged at the first stage boundary where its syndrome is zero or
    its rank among its group's still-alive unconverged frames reaches the
    stage's capacity (overflow, lane 5); every other frame at T."""
    num_iterations = sum(it for it, _ in rows_schedule) + final_iters
    total = torch.zeros(_LANES, dtype=torch.int64, device=mc.device)
    chunk = max(block_frames, _PLAIN_CHUNK // block_frames * block_frames)
    for start in range(0, batch, chunk):
        fid = torch.arange(start, min(batch, start + chunk), dtype=torch.int64,
                           device=mc.device)
        codeword, llr = mc_hash.sample(fid, mc.seed, mc.g32, mc.sigma)
        traj = _decode_edge_plain(llr, mc.h, num_iterations, mc.weights,
                                  traj=True)
        decision = traj[num_iterations]
        alive = torch.ones(len(fid), dtype=torch.bool, device=mc.device)
        overflow = torch.zeros((), dtype=torch.int64, device=mc.device)
        spent = 0
        for iters_i, rows_i in rows_schedule:
            spent += iters_i
            _, unconv = _frame_errors(mc, traj[spent], codeword)
            u = (alive & unconv).view(-1, block_frames)
            rank = torch.cumsum(u, 1) - u.to(torch.int64)
            covered = (u & (rank < rows_i)).view(-1)
            decision = torch.where((alive & ~covered)[:, None], traj[spent],
                                   decision)
            overflow += (alive & unconv & ~covered).sum()
            alive = covered
        del traj
        bit_err, unconv = _frame_errors(mc, decision, codeword)
        counters = _count(bit_err, unconv, torch.ones_like(alive))
        counters[5] = overflow
        total += counters
    return total


# the process's first fused step, one-shot or compacted, runs inside set-up
# span "setup.first_unit"
_FIRST_STEP = profiling.FirstUnit()


def fused_counters_edge(code, params: dict, variant: str, num_iterations: int,
                        snr_db: float, batch: int, seed: int,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """One-shot fused Monte-Carlo step (kernel K4 on CUDA): ``batch`` hash
    frames of ``seed`` at ``snr_db`` through ``num_iterations`` iterations
    on ``mc_setup``'s matrix (ENMS: the extended one);
    returns (5,) int64 [frames, frame_err, bit_err, detected, undetected]
    on ``device``.  Span ``mc.step``, its set-up ``mc.setup``."""
    args = (code, params, variant, num_iterations, snr_db, batch, seed, device)
    if _FIRST_STEP.pending:
        with _FIRST_STEP.span(resolve_device(device)):
            return _oneshot_step(*args)
    return _oneshot_step(*args)


def _oneshot_step(code, params, variant, num_iterations, snr_db, batch, seed,
                  device):
    with profiling.span("mc.step"):
        with profiling.span("mc.setup"):
            mc = mc_setup(code, params, variant, snr_db, seed, device)
        if mc.device.type == "cpu":
            return _mc_frames_plain(mc, num_iterations, batch)[0][:5]
        counters, _, _ = _mc_frames_kernel(mc, num_iterations, batch)
        _kernels.LAUNCHES["mc_oneshot"] += 1
        return counters[:5]


def fused_counters_edge_compact(code, params: dict, variant: str,
                                num_iterations: int, snr_db: float, batch: int,
                                seed: int, t1: int = 4, block_frames: int = 512,
                                compact_frac: float = 0.5, schedule=None,
                                device: str | torch.device = "cuda"
                                ) -> torch.Tensor:
    """Early-termination counters via convergence compaction (kernel K3 on
    CUDA): (6,) int64 [frames, frame_err, bit_err, detected, undetected,
    overflow] on ``device``, decoded on ``mc_setup``'s matrix (ENMS: the
    extended one).

    ``schedule`` is a tuple of ``(iters, frac)`` stages (fractions of
    ``block_frames``, see :func:`build_rows_schedule`); when None, one
    ``(t1, compact_frac)`` stage.  At each stage boundary a frame with a
    zero syndrome keeps that decision; of each ``block_frames`` group's
    unconverged frames the first ``rows`` (in frame order) go on, the rest
    keep the stage's decision and count in lane 5.  Frames covered through
    every stage are judged after all ``num_iterations``.  Span
    ``mc.step``, its set-up ``mc.setup``.  The process's first fused step,
    of this function or :func:`fused_counters_edge`, is set-up span
    ``setup.first_unit``."""
    if batch % block_frames:
        raise ValueError(f"batch {batch} not a multiple of {block_frames}")
    if schedule is None:
        schedule = ((t1, compact_frac),)
    rows_schedule, final_iters = build_rows_schedule(
        schedule, block_frames, num_iterations)
    args = (code, params, variant, snr_db, batch, seed, block_frames,
            rows_schedule, final_iters, device)
    if _FIRST_STEP.pending:
        with _FIRST_STEP.span(resolve_device(device)):
            return _compact_step(*args)
    return _compact_step(*args)


def _compact_step(code, params, variant, snr_db, batch, seed, block_frames,
                  rows_schedule, final_iters, device):
    with profiling.span("mc.step"):
        with profiling.span("mc.setup"):
            mc = mc_setup(code, params, variant, snr_db, seed, device)
        if mc.device.type == "cpu":
            return _compact_plain(mc, batch, block_frames, rows_schedule,
                                  final_iters)
        counters = _compact_chain(mc, batch, block_frames, rows_schedule,
                                  final_iters)
        _kernels.LAUNCHES["mc_compact"] += 1
        return counters
