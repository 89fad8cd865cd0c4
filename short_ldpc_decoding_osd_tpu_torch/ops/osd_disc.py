"""Fused TEP-discrepancy parity term: wrapper over the CUDA kernel K5.

Port of ``short_ldpc_decoding_osd_tpu/ops/osd_disc_pallas.py``
(``lterm_pallas`` :65 over ``_lterm_kernel`` :40):

    lterm[b, t] = sum_m u_l[b, m] * mod2( sum_k M[b, m, k] * T[t, k] )

The kernel (``csrc/osd_disc.cu``) runs the parity products on the int8
tensor cores and never writes the (B, m, Ntot) parity intermediate to
device memory; it takes any (m, k) whose padded frame fits shared memory
and has at most 256 rows (every packaged code).  Its tiles come from
:func:`lterm_plan`: the resident plan (``mma.sync``) for m, k <= 64, the
general plan (frame-stationary, TMA and ``wgmma``) for the rest; each
launch of the general plan adds 1 to the ``k5.general`` counter of a
recording (``utils/profiling.py``).  The caller of :func:`lterm` adds
``c0 + u_m @ T^T``.

:func:`block_minima` is K5's second entry, on the same two plans: its
epilogue finishes the discrepancy map ``d = (c0 + lterm) + u_m . t`` and
writes only the per-block minima and first argmins (the main path's
``engine.block_discrepancy_minima``); each launch adds 1 to the
``k5.block_minima`` counter, and each launch of the key decode that follows
it where a frame's TEPs are split across blocks 1 to ``k5.minima_decode``.
Both wrappers run their plain twins
(``lterm_reference``, ``block_minima_reference``) only for CPU tensors; for
CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _kernels
from ..utils import profiling
from .nms import first_argmin

THREADS = 512  # a block of the resident plan: 16 warps
SMEM_MAX = 232_448  # bytes of shared memory a block may opt in to on H100
H100_SMS = 132
TEP_TILE = 64  # TEPs a wgmma tile of the general plan
MAX_STAGES = 8  # stages a ring of the general plan
MIN_STAGES = 3  # two wgmma groups in flight beside the one being issued
MAX_ROWS = 256  # check rows a general frame (one wgmma's widest N)
BIG = 3.4e38  # an empty block's minimum: the engine's "no candidate"


@dataclasses.dataclass(frozen=True)
class LtermPlan:
    """One launch of K5.

    ``kch`` > 0: "resident" (m, k <= 64: the frame's B fragments,
    ``m_pad`` x ``k_pad`` = 8 ``tn`` x 32 ``kch``, held in registers).  A
    block holds ``nt`` TEPs (rows of T, zero-padded to k_pad, rows
    ``stride`` bytes apart) in shared memory and walks frames ``grid[0]``
    apart through ``nbuf`` frame buffers; ``grid[1]`` = ``n_tiles`` blocks
    cover the TEPs.

    ``kch`` == 0: "general" (any m > 64 or k > 64, m <= 256).  What bounds
    it: 2 b m k N int8 MACs at 1,979 TOP/s, and all of T once a frame
    through L2 (every frame meets every TEP; 94 GB a WiMAX round).  The
    design: a block holds one frame's M in shared memory (``m_pad`` = m
    rounded up to 16 rows, the wgmma width; ``k_pad`` = k rounded up to the
    k-slice ``stride`` of 32, 64 or 128 bytes, the row of the swizzled
    layout) and streams TEP tiles of 64 x ``stride`` bytes through two
    rings of ``stages`` stages by TMA into wgmma, so M is read once a unit
    and the blocks sweep T in step (served from L2: T's traffic measured
    no bound).  A unit is one frame against ``nt`` TEPs (``nt`` / 64
    tiles); ``n_tiles`` units cover a frame's TEPs, and ``grid[0]``
    persistent blocks (one an SM) walk the b x ``n_tiles`` units; ``tn``
    0, ``nbuf`` 1, ``grid[1]`` 1."""

    kch: int
    tn: int
    m_pad: int
    k_pad: int
    stride: int  # resident: k_pad + 16; general: the k-slice in bytes
    nt: int
    n_tiles: int
    nbuf: int
    smem_bytes: int
    grid: tuple[int, int]
    stages: int = 0  # general: stages a ring
    blocks: int = 0  # block minima: the blocks P (0: lterm)

    @property
    def resident(self) -> bool:
        return self.kch > 0


def _smem(stride: int, m_pad: int, nt: int, nbuf: int, blocks: int = 0) -> int:
    # T tile, then nbuf x (a frame's M rows + its u_l as f64); for block
    # minima two buffers of P 8-byte keys and nbuf frames' u_m as f32
    minima = 16 * blocks + 4 * nbuf * (stride - 16) if blocks else 0
    return stride * nt + nbuf * (stride * m_pad + 8 * m_pad) + minima


def general_smem(m_pad: int, k_pad: int, kslice: int, stages: int,
                 blocks: int = 0) -> int:
    """Shared bytes of a general block: 1,024 of alignment slack, two rings
    of ``stages`` stages (64 TEPs x ``kslice`` bytes, two 8-byte barriers
    each), the frame's M and its u as f64; for block minima (``blocks`` >
    0) also its u_m as f32."""
    return (1024 + 2 * stages * (TEP_TILE * kslice + 16) + m_pad * k_pad
            + 8 * m_pad + (4 * k_pad if blocks else 0))


@functools.lru_cache(maxsize=256)
def lterm_plan(b: int, m: int, k: int, ntot: int, sms: int = H100_SMS,
               blocks: int = 0) -> LtermPlan | None:
    """The tile plan of K5 for M (b, m, k) and T (ntot, k) on a card with
    ``sms`` SMs, for :func:`lterm` or (``blocks`` = P > 0) for
    :func:`block_minima`, or None where a padded frame does not fit a
    block's shared memory (far above every packaged code) or has more than
    256 check rows."""
    if min(b, m, k, ntot) < 1 or blocks < 0:
        raise ValueError(f"lterm_plan needs positive sizes, got "
                         f"{(b, m, k, ntot, blocks)}")
    if k > 64 or m > 64:
        return _general_plan(b, m, k, ntot, sms, blocks)
    kch, tn, m_pad, k_pad = 2, 8, 64, 64
    stride = k_pad + 16  # odd multiple of 16 bytes: ldmatrix conflict-free
    n16 = -(-ntot // 16) * 16
    choice = None
    for nbuf in (2, 1):
        fit = ((SMEM_MAX - _smem(stride, m_pad, 0, nbuf, blocks))
               // stride // 16 * 16)
        if fit >= min(n16, 256) or (nbuf == 1 and fit >= 16):
            choice = nbuf, fit
            break
    if choice is None:
        return None
    nbuf, fit = choice
    n_tiles = -(-n16 // fit)
    nt = -(-(-(-ntot // n_tiles)) // 16) * 16  # balanced tiles of 16
    grid_x = max(1, min(b, sms // n_tiles))
    return LtermPlan(kch=kch, tn=tn, m_pad=m_pad, k_pad=k_pad, stride=stride,
                     nt=nt, n_tiles=n_tiles, nbuf=nbuf,
                     smem_bytes=_smem(stride, m_pad, nt, nbuf, blocks),
                     grid=(grid_x, n_tiles), blocks=blocks)


def _general_plan(b: int, m: int, k: int, ntot: int, sms: int,
                  blocks: int) -> LtermPlan | None:
    m_pad = -(-m // 16) * 16
    if m_pad > MAX_ROWS:
        return None
    # the widest k-slice among those that pad k least (WiMAX's 880: 128;
    # wimaxlike's 192: 64)
    kslice = min((128, 64, 32), key=lambda s: -(-k // s) * s)
    k_pad = -(-k // kslice) * kslice
    stages = min(MAX_STAGES,
                 (SMEM_MAX - general_smem(m_pad, k_pad, kslice, 0, blocks))
                 // (2 * (TEP_TILE * kslice + 16)))
    if stages < MIN_STAGES:
        return None
    tiles = -(-ntot // TEP_TILE)
    # TEP tiles a unit: the least makespan of ceil(units / sms) waves, a
    # unit costing its tiles plus ~3 tiles of staging and drain, among the
    # cuts that give every SM a unit wherever b x tiles allows
    need = min(sms, b * tiles)
    best = None
    for tpc in range(1, tiles + 1):
        chunks = -(-tiles // tpc)
        if b * chunks < need:
            break
        cost = -(-(b * chunks) // sms) * (tpc + 3)
        if best is None or cost <= best[0]:
            best = cost, tpc, chunks
    _, tpc, chunks = best
    return LtermPlan(kch=0, tn=0, m_pad=m_pad, k_pad=k_pad, stride=kslice,
                     nt=TEP_TILE * tpc, n_tiles=chunks, nbuf=1,
                     smem_bytes=general_smem(m_pad, k_pad, kslice, stages,
                                             blocks),
                     grid=(min(sms, b * chunks), 1), stages=stages,
                     blocks=blocks)


def lterm_reference(m_matrix: torch.Tensor, u_l: torch.Tensor,
                    teps_flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: materializes the (B, m, Ntot) parity tensor.
    f32 products of 0/1 operands are exact, and row sums <= k < 2^24; the
    parity is taken in place as ``2 * frac(x / 2)``, which is exact for
    those integers (the same 0/1 values as ``x - 2 floor(x / 2)``, without
    its temporaries)."""
    prods = torch.einsum("bmk,nk->bmn", m_matrix.to(torch.float32),
                         teps_flat.to(torch.float32))
    a = prods.mul_(0.5).frac_().mul_(2.0)
    return torch.einsum("bm,bmn->bn", u_l.to(torch.float32), a)


def tep_positions(teps_flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The position list of the TEP rows (N, k) 0/1: ``(heads, cols)`` on
    ``teps_flat``'s device.  cols int16 holds each row's set columns,
    ascending, row after row (CSR); heads int32 (N, 4) gives row t's offset
    o in cols, its count n, and its first three columns c0 | c1 << 16 and
    c2 (0 where there are fewer), so that K5 reads a row of the path's
    TEPs (1-3 set columns) with one 16-byte load."""
    n, k = teps_flat.shape
    if k > 2**15:
        raise ValueError(f"tep_positions: {k} columns do not fit int16")
    rows, cols = torch.nonzero(teps_flat, as_tuple=True)  # row-major order
    counts = torch.bincount(rows, minlength=n)
    offsets = torch.cumsum(counts, 0) - counts
    first = []
    for j in range(3):
        at = torch.clamp(offsets + j, max=max(cols.numel() - 1, 0))
        has = counts > j
        first.append(torch.where(has, cols[at], 0) if cols.numel()
                     else torch.zeros_like(counts))
    heads = torch.stack([offsets, counts, first[0] + first[1] * 2**16, first[2]],
                        1).to(torch.int32)
    return heads.contiguous(), cols.to(torch.int16)


def block_minima_reference(m_matrix, u_l, c0, u_m, teps_flat, block_of,
                           starts, ntot: int, lterm_vals=None):
    """Plain PyTorch twin of :func:`block_minima`: the discrepancies
    ``(c0 + lterm) + u_m @ T^T`` (B, N) in f32, ``lterm`` being
    ``lterm_vals`` where the caller has it (K5's :func:`lterm` on the card)
    or :func:`lterm_reference`; then each block's ``amin`` and
    ``first_argmin`` over its TEPs below ``ntot``, the argmin less the
    block's start, (``BIG``, 0) for a block with none."""
    if lterm_vals is None:
        lterm_vals = lterm_reference(m_matrix, u_l, teps_flat)
    disc = (c0[:, None] + lterm_vals) + u_m @ teps_flat.T.to(torch.float32)
    b, n = disc.shape
    blocks = starts.shape[0]
    member = torch.where(torch.arange(n, device=disc.device) < ntot,
                         block_of.to(torch.int64), -1)
    # each block's TEPs, in order: one sort and one read of the counts
    order = torch.argsort(torch.where(member < 0, blocks, member), stable=True)
    counts = torch.bincount(member[member >= 0], minlength=blocks).tolist()
    minima = torch.full((b, blocks), BIG, dtype=torch.float32, device=disc.device)
    argmins = torch.zeros((b, blocks), dtype=torch.int64, device=disc.device)
    for p, idx in enumerate(torch.split(order[:sum(counts)], counts)):
        if idx.numel():
            part = disc[:, idx]
            minima[:, p] = part.amin(1)
            argmins[:, p] = idx[first_argmin(part, 1)] - starts[p]
    return minima, argmins


def lterm_occupancy(plan: LtermPlan, device: int = 0) -> dict:
    """What the card makes of ``plan``'s kernel: registers and local bytes
    a thread, threads a block, resident blocks per SM, SMs, static shared
    bytes."""
    out = (ctypes.c_int * 6)()
    status = _kernels.library("osd_disc").lterm_occupancy(
        plan.kch, plan.tn, plan.m_pad, plan.smem_bytes, int(plan.blocks > 0),
        device, out)
    _kernels.check(status, "lterm_occupancy")
    return dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                     "sms", "static_smem_bytes"), list(out)))


def launch(lib, plan: LtermPlan, m_matrix: torch.Tensor, u_l: torch.Tensor,
           teps_flat: torch.Tensor, out: torch.Tensor) -> int:
    """Launch ``plan`` from ``lib`` (the built ``osd_disc`` library, or a
    variant of it with the same entry points) into ``out``; returns its
    status.  The general plan reads T through a tensor map, whose rows must
    be 16-byte multiples on a 16-byte boundary: T of another width (the
    ragged case) is copied with zero columns up to the next 16 bytes."""
    b, m, k = m_matrix.shape
    ntot = teps_flat.shape[0]
    stream = _kernels.stream_handle(m_matrix.device)
    if plan.resident:
        return lib.lterm_launch(
            m_matrix.data_ptr(), u_l.data_ptr(), teps_flat.data_ptr(),
            out.data_ptr(), b, m, k, ntot, plan.kch, plan.tn, plan.m_pad,
            plan.k_pad, plan.nt, plan.n_tiles, plan.nbuf, plan.grid[0],
            plan.smem_bytes, stream)
    if k % 16 or teps_flat.data_ptr() % 16:
        teps_flat = torch.nn.functional.pad(teps_flat, (0, -(-k // 16) * 16 - k))
    return lib.lterm_general_launch(
        m_matrix.data_ptr(), u_l.data_ptr(), teps_flat.data_ptr(),
        out.data_ptr(), b, m, k, ntot, teps_flat.shape[1], plan.m_pad,
        plan.k_pad, plan.stride, plan.stages, plan.nt, plan.n_tiles,
        plan.grid[0], plan.smem_bytes, stream)


def _check_operands(what: str, m_matrix: torch.Tensor, u_l: torch.Tensor,
                    teps_flat: torch.Tensor, **extra: tuple) -> None:
    """Raise unless M (B, m, k) int8, u_l (B, m) f32, T (N, k) int8 and
    each ``extra`` tensor (its dtype, its shape) are contiguous on one CUDA
    device."""
    if m_matrix.device.type != "cuda":
        raise ValueError(f"unsupported device {m_matrix.device}")
    if m_matrix.dim() != 3 or teps_flat.dim() != 2:
        raise ValueError(f"{what} takes a 3-d m_matrix and a 2-d teps_flat")
    b, m, k = m_matrix.shape
    if (m_matrix.dtype != torch.int8 or teps_flat.dtype != torch.int8
            or u_l.dtype != torch.float32):
        raise ValueError(f"{what} takes int8 m_matrix/teps and float32 u_l")
    if u_l.shape != (b, m) or teps_flat.shape[1] != k:
        raise ValueError(
            f"shape mismatch: M {tuple(m_matrix.shape)}, u_l "
            f"{tuple(u_l.shape)}, teps {tuple(teps_flat.shape)}"
        )
    tensors = {"m_matrix": m_matrix, "u_l": u_l, "teps": teps_flat}
    for name, (t, dtype, shape) in extra.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors[name] = t
    for name, t in tensors.items():
        if not t.is_contiguous() or t.device != m_matrix.device:
            raise ValueError(f"{name} must be contiguous on {m_matrix.device}")


def _plan_on(m_matrix: torch.Tensor, ntot: int, blocks: int = 0) -> LtermPlan:
    """K5's plan for M on its card's SMs, or raise where none fits."""
    b, m, k = m_matrix.shape
    dev = m_matrix.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    plan = lterm_plan(b, m, k, ntot,
                      torch.cuda.get_device_properties(dev).multi_processor_count,
                      blocks)
    if plan is None:
        raise ValueError(f"K5: a padded ({m}, {k}) frame does not fit a "
                         f"block's {SMEM_MAX} bytes of shared memory, or has "
                         f"more than {MAX_ROWS} rows")
    return plan


def lterm(m_matrix: torch.Tensor, u_l: torch.Tensor,
          teps_flat: torch.Tensor) -> torch.Tensor:
    """(B, Ntot) f32 ``sum_m u_l * mod2(M @ T^T)`` (kernel K5 on CUDA).

    ``m_matrix`` (B, m, k) int8 0/1, ``u_l`` (B, m) f32, ``teps_flat``
    (Ntot, k) int8 0/1, all contiguous on one device."""
    if m_matrix.device.type == "cpu":
        return lterm_reference(m_matrix, u_l, teps_flat)
    _check_operands("lterm", m_matrix, u_l, teps_flat)
    b, m, k = m_matrix.shape
    ntot = teps_flat.shape[0]
    if min(b, ntot) == 0 or min(m, k) == 0:
        # nothing to launch: no rows, or every parity is 0
        return torch.zeros((b, ntot), dtype=torch.float32,
                           device=m_matrix.device)
    plan = _plan_on(m_matrix, ntot)
    out = torch.empty((b, ntot), dtype=torch.float32, device=m_matrix.device)
    status = launch(_kernels.library("osd_disc"), plan, m_matrix, u_l,
                    teps_flat, out)
    _kernels.check(status, "lterm_launch")
    _kernels.LAUNCHES["lterm"] += 1
    if not plan.resident:
        profiling.count("k5.general", 1)
    return out


def block_minima(m_matrix: torch.Tensor, u_l: torch.Tensor, c0: torch.Tensor,
                 u_m: torch.Tensor, teps_flat: torch.Tensor, positions: tuple,
                 block_of: torch.Tensor, starts: torch.Tensor, ntot: int):
    """Per-block minima (B, P) f32 and first argmins (B, P) int64 of the
    discrepancies ``d = (c0 + lterm) + u_m . t`` over the TEP rows t <
    ``ntot`` of ``teps_flat`` (N, k) that lie in a block (``block_of[t]`` =
    its block, -1 for none), each argmin less its block's start ``starts``
    (P,) int64; an empty block (``BIG``, 0).  Kernel K5 on CUDA, whose
    epilogue forms d in f32 in that order (lterm rounded once from its f64
    sum, ``u_m . t`` summed over t's set columns, ascending) and reduces it
    without writing the (B, N) map; ``positions`` is
    :func:`tep_positions` of ``teps_flat``.  ``c0`` (B,) and ``u_m`` (B, k)
    f32; the rest as :func:`lterm`.  The parity MMAs run over all N rows."""
    if m_matrix.device.type == "cpu":
        return block_minima_reference(m_matrix, u_l, c0, u_m, teps_flat,
                                      block_of, starts, ntot)
    b, m, k = m_matrix.shape
    n, blocks = teps_flat.shape[0], starts.shape[0]
    heads, cols = positions
    _check_operands("block_minima", m_matrix, u_l, teps_flat,
                    c0=(c0, torch.float32, (b,)),
                    u_m=(u_m, torch.float32, (b, k)),
                    heads=(heads, torch.int32, (n, 4)),
                    cols=(cols, torch.int16, tuple(cols.shape)),
                    block_of=(block_of, torch.int32, (n,)),
                    starts=(starts, torch.int64, (blocks,)))
    if min(m, k, n, blocks) < 1 or not 0 <= ntot <= n:
        raise ValueError(f"block_minima: M {tuple(m_matrix.shape)}, {n} TEPs, "
                         f"{blocks} blocks, ntot {ntot}")
    dev = m_matrix.device
    minima = torch.empty((b, blocks), dtype=torch.float32, device=dev)
    argmins = torch.empty((b, blocks), dtype=torch.int64, device=dev)
    if b == 0:
        return minima, argmins
    plan = _plan_on(m_matrix, n, blocks)
    keys = None
    if not (plan.resident and plan.n_tiles == 1):
        # the kernel's "no TEP yet" key, INT64_MAX, in every block
        keys = torch.full((b, blocks), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=dev)
    lib = _kernels.library("osd_disc")
    stream = _kernels.stream_handle(dev)
    ptrs = [t.data_ptr() for t in (m_matrix, u_l, teps_flat, c0, u_m, heads,
                                   cols, block_of)]
    if plan.resident:
        status = lib.block_minima_launch(
            *ptrs, starts.data_ptr(), 0 if keys is None else keys.data_ptr(),
            minima.data_ptr(), argmins.data_ptr(), b, m, k, n, ntot, blocks,
            plan.kch, plan.tn, plan.m_pad, plan.k_pad, plan.nt, plan.n_tiles,
            plan.nbuf, plan.grid[0], plan.smem_bytes, stream)
    else:
        if k % 16 or teps_flat.data_ptr() % 16:  # TMA rows, as in launch()
            teps_flat = torch.nn.functional.pad(teps_flat,
                                                (0, -(-k // 16) * 16 - k))
            ptrs[2] = teps_flat.data_ptr()
        status = lib.block_minima_general_launch(
            *ptrs, keys.data_ptr(), b, m, k, n, ntot, blocks,
            teps_flat.shape[1], plan.m_pad, plan.k_pad, plan.stride,
            plan.stages, plan.nt, plan.n_tiles, plan.grid[0], plan.smem_bytes,
            stream)
    _kernels.check(status, "block_minima_launch")
    _kernels.LAUNCHES["lterm"] += 1
    profiling.count("k5.block_minima", 1)
    if not plan.resident:
        profiling.count("k5.general", 1)
    if keys is not None:
        status = lib.minima_decode(keys.data_ptr(), starts.data_ptr(),
                                   minima.data_ptr(), argmins.data_ptr(), b,
                                   blocks, stream)
        _kernels.check(status, "minima_decode")
        profiling.count("k5.minima_decode", 1)
    return minima, argmins
