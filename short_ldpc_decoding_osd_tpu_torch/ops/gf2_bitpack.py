"""Bit-packed batched GF(2) elimination, and its CUDA kernel on the card.

Port of ``short_ldpc_decoding_osd_tpu/ops/gf2_bitpack.py`` (XLA there, not a
Pallas kernel).  Columns are bits: the work tensor is ``(m, nw, B)`` int32,
nw = ceil(n / 32), column ``j`` of frame ``b`` in bit ``j % 32`` of word
``[i, j // 32, b]``.  Every public function keeps the JAX name, layout and
dtype, is plain PyTorch on any device, and gives JAX's words bit for bit.

The pivot rule is that of ``gf2ops.batched_row_reduce`` (first pivot row at
or below t, else the first column c > t with a 1 in row t), with one
difference on rank-deficient matrices: at a step with neither a pivot nor
a swap column the packed route leaves the columns alone, where the dense
route's first-index rule swaps column t with column 0.  So the packed
route is held to JAX's packed route, step for step.

The words are int32 as in JAX, so bit 31 makes a word negative.  Negation
and shifts that reach bit 31 run in int64 and are narrowed to the low 32
bits (:func:`_narrow`): ``x & -x`` and ``-(2 << jb)`` then give JAX's
two's-complement words.

:func:`reduce_from_perm` and :func:`reduce_dense` are the wrappers of the
CUDA kernel ``csrc/gf2_ge.cu`` (launch count ``"ge_packed"``): on a CPU
tensor they run the plain twins :func:`_reduce_perm_plain` and
:func:`_reduce_dense_plain`; on a CUDA tensor they launch the kernel or
raise.  The kernel's threads own columns (a column's rows in registers);
its plan (one warp a frame, or one block a frame) comes from
:func:`ge_plan`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from ..codes import tables
from .nms import first_index

WARP_FRAMES = 8  # frames (warps) a block in the warp mode
LANE_COLS = 4  # columns a lane in the warp mode, at most (l, l + 32, ...)
BLOCK_MAX_THREADS = 256  # threads a block in the block mode, at most
# the block kernel's instantiations (csrc/gf2_ge.cu pick_block): words a
# column (ceil(m/32) rounded up) and columns a thread
BLOCK_WORDS = (2, 4, 6, 8)
BLOCK_COLS = (2, 4, 6)


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _i32(v: int) -> int:
    """A Python int -> the int32 value with the same low 32 bits."""
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _fill(cond: torch.Tensor) -> torch.Tensor:
    """bool -> int32 all-ones (-1) where true, 0 elsewhere."""
    return -cond.to(torch.int32)


def _bit_words(n: int, device) -> torch.Tensor:
    """(n,) int32: ``1 << (j % 32)``."""
    j = torch.arange(n, device=device)
    return _narrow(torch.ones_like(j) << (j % 32))


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if x.shape[dim] == size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim)


def pack_columns(h_batch: torch.Tensor) -> torch.Tensor:
    """(B, m, n) 0/1 -> (m, ceil(n/32), B) int32, bit j%32 of word j//32 = col j."""
    b, m, n = h_batch.shape
    nw = -(-n // 32)
    x = _pad_to(h_batch.to(torch.int64), 2, nw * 32).reshape(b, m, nw, 32)
    words = (x << torch.arange(32, device=x.device)).sum(3)
    return _narrow(words).permute(1, 2, 0).contiguous()


def unpack_columns(packed: torch.Tensor, n: int, dtype=torch.int8) -> torch.Tensor:
    """(m, nw, B) int32 -> (B, m, n) 0/1 of ``dtype``."""
    dev = packed.device
    word_of = torch.arange(n, device=dev) // 32
    sel = packed[:, word_of, :]  # (m, n, B)
    bits = (sel & _bit_words(n, dev)[None, :, None]) != 0
    return bits.permute(2, 0, 1).to(dtype).contiguous()


def pack_permuted(invperm: torch.Tensor, h) -> torch.Tensor:
    """Column-permuted and bit-packed work tensor, (m, nw, B) int32.

    ``invperm`` is the (B, n) INVERSE reliability permutation: original
    column ``j`` lands at position ``invperm[b, j]``.  JAX composes this
    with the packing weights in an MXU matmul; here it is an exact shift
    of each entry of H to its position's bit and a sum per word (the bits
    of a word are distinct, so the sum is their OR)."""
    b, n = invperm.shape
    nw = -(-n // 32)
    h = tables.int8(h, invperm.device).to(torch.int64)
    m = h.shape[0]
    pos = invperm.to(torch.int64)
    vals = h[None, :, :] << (pos % 32)[:, None, :]  # (B, m, n)
    words = torch.zeros((b, m, nw), dtype=torch.int64, device=h.device)
    words.scatter_add_(2, (pos // 32)[:, None, :].expand(b, m, n), vals)
    return _narrow(words).permute(1, 2, 0).contiguous()


def unpack_tail_columns(packed: torch.Tensor, n: int, k: int,
                        dtype=torch.int8) -> torch.Tensor:
    """Dense (B, m, k) of the LAST k columns only (the M-matrix source)."""
    m, nw, b = packed.shape
    w0 = (n - k) // 32
    x = packed[:, w0:, :].permute(2, 0, 1)  # (B, m, nw - w0)
    bits = (x[..., None] & _bit_words(32, packed.device)) != 0
    cols = bits.reshape(b, m, (nw - w0) * 32)
    off = (n - k) - w0 * 32
    return cols[:, :, off:off + k].to(dtype).contiguous()


def pack_positions(bits: torch.Tensor, nw: int) -> torch.Tensor:
    """(n, B) 0/1 -> (nw, B) int32: position p -> bit p%32 of word p//32."""
    n, b = bits.shape
    x = _pad_to(bits.to(torch.int64), 0, nw * 32).reshape(nw, 32, b)
    shifts = torch.arange(32, device=x.device)[None, :, None]
    return _narrow((x << shifts).sum(1))


def _reduce_packed(mat: torch.Tensor, col_order: torch.Tensor, m_steps: int):
    """Core loop over ``m_steps`` pivots on the packed (m, nw, B) tensor;
    ``col_order`` (n, B) int32 is carried as bit-plane tags in the packed
    layout (a column swap is a masked XOR per plane) and decoded back to a
    dense (n, B) order at the end.  Returns ``(mat, col_order)``."""
    m, nw, b = mat.shape
    n = col_order.shape[0]
    dev = mat.device
    iota_m = torch.arange(m, device=dev)[:, None]  # (m, 1)
    iota_w = torch.arange(nw, device=dev)[:, None]  # (nw, 1)
    word_of_n = torch.arange(n, device=dev) // 32
    bit_of_n = _bit_words(n, dev)[:, None]  # (n, 1)
    levels = max(1, int(n - 1).bit_length())
    tags = torch.stack([pack_positions((col_order >> lv) & 1, nw)
                        for lv in range(levels)], 0)  # (L, nw, B)
    for t in range(m_steps):
        jw, jb = divmod(t, 32)
        bit_t = _i32(1 << jb)
        col_t = (mat[:, jw, :] & bit_t) != 0  # (m, B)
        cm = col_t & (iota_m >= t)
        has_p = cm.any(0, keepdim=True)  # (1, B)
        pivot_row = first_index(cm, 0)[None, :]  # (1, B)

        # swap-column search: first set bit > t in row t
        row_t = mat[t]  # (nw, B)
        mask_hi = _i32(-(2 << jb))  # bits jb+1.. of word jw (0 at jb = 31)
        wmask = torch.where(iota_w < jw, 0, torch.where(iota_w == jw, mask_hi, -1))
        cand = row_t & wmask.to(torch.int32) & ~_fill(has_p)
        c64 = cand.to(torch.int64)
        low = _narrow(c64 & -c64)  # per-word lowest set bit
        nz = low != 0
        seen = torch.zeros((1, b), dtype=torch.bool, device=dev)
        sc_words = []
        for w in range(nw):
            sc_words.append(torch.where(seen[0] | ~nz[w], 0, low[w]))
            seen = seen | nz[w][None, :]
        scmask = torch.stack(sc_words, 0)  # (nw, B): <= 1 bit set per frame
        sc_any = seen

        # column swap t <-> sc (gated by sc_any)
        s_col = ((mat & scmask[None, :, :]) != 0).any(1)  # (m, B)
        dcol = (s_col ^ col_t) & sc_any
        tmask = torch.where(iota_w == jw, bit_t, 0).to(torch.int32)  # (nw, 1)
        cmask = scmask | tmask  # (nw, B)

        # row swap t <-> pivot_row on the post-column-swap matrix
        pr_gated = (iota_m == pivot_row) & has_p  # (m, B)
        p_row = torch.where(pr_gated[:, None, :], mat, 0).sum(0).to(torch.int32)
        dcol_at_t = ((iota_m == t) & dcol).any(0, keepdim=True)
        dcol_at_pr = (pr_gated & dcol).any(0, keepdim=True)
        row_t2 = row_t ^ (cmask & _fill(dcol_at_t))
        p_row2 = p_row ^ (cmask & _fill(dcol_at_pr))
        drow = (p_row2 ^ row_t2) & _fill(has_p)  # (nw, B)
        rmask = (iota_m == t) | pr_gated  # (m, B)

        # elimination of column t outside row t
        piv = row_t2 ^ drow  # the final row t
        drow_at_tcol = ((drow & tmask) != 0).any(0, keepdim=True)
        new_col_t = (col_t ^ dcol) ^ (rmask & drow_at_tcol)
        colv = new_col_t & (iota_m != t)
        mat = mat ^ ((cmask[None, :, :] & _fill(dcol)[:, None, :])
                     ^ (_fill(rmask)[:, None, :] & drow[None, :, :])
                     ^ (_fill(colv)[:, None, :] & piv[None, :, :]))

        # order-tag swap t <-> sc
        tag_t = (tags[:, jw, :] & bit_t) != 0  # (L, B)
        tag_sc = ((tags & scmask[None, :, :]) != 0).any(1)  # (L, B)
        diff = (tag_t ^ tag_sc) & sc_any
        tags = tags ^ (cmask[None, :, :] & _fill(diff)[:, None, :])
    planes = (tags[:, word_of_n, :] & bit_of_n[None]) != 0  # (L, n, B)
    weights = (1 << torch.arange(levels, device=dev))[:, None, None]
    col_order = torch.where(planes, weights, 0).sum(0).to(torch.int32)
    return mat, col_order


def _identity_order(n: int, b: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[:, None].expand(n, b)


def _reduce_dense_plain(h_batch: torch.Tensor, tail: int):
    """Plain twin of the kernel's dense load: the last ``tail`` columns of
    the reduced (B, m, n) batch as int8 and col_order (B, n) int32."""
    b, m, n = h_batch.shape
    mat, col_order = _reduce_packed(pack_columns(h_batch),
                                    _identity_order(n, b, h_batch.device), m)
    return unpack_tail_columns(mat, n, tail), col_order.T.contiguous()


def _reduce_perm_plain(perm: torch.Tensor, h, k: int):
    """Plain twin of the kernel's perm load (JAX's packed branch of
    ``identify_mrb_from_perm`` before ``_mrb_post``): the reduced (B, m, k)
    int8 tail of ``h``'s columns in ``perm`` order, and col_order (B, n)
    int32."""
    b, n = perm.shape
    m = np.shape(h)[0]
    invperm = torch.argsort(perm, dim=-1)  # perm is a permutation: exact
    mat, col_order = _reduce_packed(pack_permuted(invperm, h),
                                    _identity_order(n, b, perm.device), m)
    return unpack_tail_columns(mat, n, k), col_order.T.contiguous()


def batched_row_reduce_bitpack(h_batch: torch.Tensor):
    """Drop-in for ``gf2ops.batched_row_reduce`` on the packed route:
    ``(reduced (B, m, n) int8, col_order (B, n) int32)``; the CUDA kernel on
    a CUDA tensor."""
    return reduce_dense(h_batch, h_batch.shape[2])


# --------------------------------------------------------------------------
# the CUDA kernel


@dataclasses.dataclass(frozen=True)
class GePlan:
    """One launch of the GE kernel, whose threads own columns, each
    column's ``words`` words of rows in registers: a frame's T threads own
    its columns i + T s, ``cols`` of them a thread.  ``warp``: a frame on
    one warp (T = 32, ``cols`` = ceil(n/32) <= ``LANE_COLS``),
    ``WARP_FRAMES`` frames a block; ``block``: a frame on one block of
    ``threads`` = T >= m threads, so that column t < m is thread t's
    first."""

    mode: str
    words: int
    cols: int
    threads: int
    grid: int

    @property
    def frames_per_block(self) -> int:
        return WARP_FRAMES if self.mode == "warp" else 1


@functools.lru_cache(maxsize=256)
def ge_plan(b: int, m: int, n: int) -> GePlan | None:
    """The GE kernel's launch for ``b`` frames of (m, n), or None where a
    frame's columns do not fit the kernel's registers (m > 256 rows, or more
    than ``BLOCK_COLS[-1]`` columns for each of ``BLOCK_MAX_THREADS``)."""
    if min(b, m, n) < 1:
        raise ValueError(f"ge_plan needs positive sizes, got {(b, m, n)}")
    mw = -(-m // 32)
    if m <= 64 and n <= 32 * LANE_COLS:
        return GePlan("warp", mw, -(-n // 32), WARP_FRAMES * 32,
                      -(-b // WARP_FRAMES))
    threads = 32 * max(mw, -(-n // (32 * BLOCK_COLS[-1])))
    words = next((w for w in BLOCK_WORDS if w >= mw), None)
    cols = next((c for c in BLOCK_COLS if c * threads >= n), None)
    if words is None or cols is None or threads > BLOCK_MAX_THREADS:
        return None
    return GePlan("block", words, cols, threads, b)


def ge_occupancy(plan: GePlan, m: int, n: int, device: int = 0) -> dict:
    """What the card makes of ``plan``'s kernel for (m, n) frames: registers
    and local bytes a thread, threads a block, resident blocks and frames
    per SM, SMs, static shared bytes."""
    out = (ctypes.c_int * 6)()
    status = _kernels.library("gf2_ge").ge_occupancy(
        m, n, 0 if plan.mode == "warp" else 1, plan.words, plan.cols,
        plan.threads, device, out)
    _kernels.check(status, "ge_occupancy")
    occ = dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                    "sms", "static_smem_bytes"), list(out)))
    occ["frames_per_sm"] = occ["blocks_per_sm"] * plan.frames_per_block
    return occ


def _packed_h_columns(h, device) -> torch.Tensor:
    """The static (m, n) H packed by columns on ``device`` (a
    ``codes.tables`` item): (n, ceil(m/32)) int32, bit r%32 of word r//32
    of column j = h[r, j], the kernel's perm-load operand."""
    cols = torch.as_tensor(h.T.copy())[None]  # (1, n, m) as a "batch"
    return pack_columns(cols)[:, :, 0].contiguous().to(device)


def _launch(b: int, m: int, n: int, tail: int, device, perm=None, hcol=None,
            dense=None):
    plan = ge_plan(b, m, n)
    if plan is None:
        raise ValueError(f"GE kernel: the columns of a ({m}, {n}) frame do not "
                         "fit its registers (at most 256 rows, and "
                         f"{BLOCK_COLS[-1]} columns for each of "
                         f"{BLOCK_MAX_THREADS} threads)")
    out = torch.empty((b, m, tail), dtype=torch.int8, device=device)
    order = torch.empty((b, n), dtype=torch.int32, device=device)
    status = _kernels.library("gf2_ge").ge_launch(
        0 if perm is None else perm.data_ptr(),
        0 if hcol is None else hcol.data_ptr(),
        0 if hcol is None else hcol.shape[1],
        0 if dense is None else dense.data_ptr(),
        out.data_ptr(), order.data_ptr(), b, m, n, n - tail,
        0 if plan.mode == "warp" else 1, plan.words, plan.cols, plan.threads,
        plan.grid, _kernels.stream_handle(device))
    _kernels.check(status, "ge_launch")
    _kernels.LAUNCHES["ge_packed"] += 1
    return out, order


def _check_device(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain twin), False for CUDA; raises else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def reduce_from_perm(perm: torch.Tensor, h, k: int):
    """The reduced (B, m, k) int8 tail and col_order (B, n) int32 of the
    static (m, n) ``h`` with its columns in each frame's ``perm`` order
    (a (B, n) permutation); the kernel's perm load on CUDA."""
    if _check_device(perm):
        return _reduce_perm_plain(perm, h, k)
    b, n = perm.shape
    m = np.shape(h)[0]
    if np.shape(h)[1] != n or not 0 < k <= n:
        raise ValueError(f"reduce_from_perm: perm {tuple(perm.shape)}, h "
                         f"{np.shape(h)}, k {k}")
    if b == 0:
        return _launch_empty(b, m, n, k, perm.device)
    perm = perm.to(torch.int64).contiguous()
    hcol = tables.get(h, _packed_h_columns, perm.device)
    return _launch(b, m, n, k, perm.device, perm=perm, hcol=hcol)


def reduce_dense(h_batch: torch.Tensor, tail: int):
    """The last ``tail`` columns (int8) of the reduced (B, m, n) batch and
    col_order (B, n) int32; the kernel's dense load on CUDA."""
    if _check_device(h_batch):
        return _reduce_dense_plain(h_batch, tail)
    b, m, n = h_batch.shape
    if not 0 < tail <= n:
        raise ValueError(f"reduce_dense: tail {tail} of {n} columns")
    if b == 0:
        return _launch_empty(b, m, n, tail, h_batch.device)
    dense = h_batch.to(torch.int8).contiguous()
    return _launch(b, m, n, tail, h_batch.device, dense=dense)


def _launch_empty(b, m, n, tail, device):
    return (torch.empty((b, m, tail), dtype=torch.int8, device=device),
            torch.empty((b, n), dtype=torch.int32, device=device))
