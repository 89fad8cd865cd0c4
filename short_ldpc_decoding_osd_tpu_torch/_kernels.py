"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` (next to
the package, git-ignored), then loaded with ``ctypes``.  All sources build
at the first CUDA use, one ``nvcc`` process per source, all started
together.  The library file name carries a digest of its source and of the
shared headers (``csrc/*.cuh``), so an edited kernel is never served by a
stale build.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.  ``reset_launches`` sets every count to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .utils import profiling

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("nms_edge", "osd_disc", "mc_fused", "nms_dense", "gf2_ge")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add: the kernels then round exactly like their plain
    # PyTorch twins, which multiply and add in separate steps
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"nms_edge_final": 0, "nms_edge_traj": 0, "nmsr_edge_final": 0,
            "nmsr_edge_traj": 0, "lterm": 0,
            "mc_oneshot": 0, "mc_compact": 0, "cascade_p1": 0, "cascade_p2": 0,
            "dense_final": 0, "mc_dense": 0, "ge_packed": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc and its -Xptxas -v report, per source
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}

_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    "nms_edge": {
        # llr, out, edge_col, var_edges, split, batch, n, m, dc, dv, iters,
        # w_vc, w_chk, w_marg, traj, bucket, warps, frames, lanes, stream
        "nms_edge_decode": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                            _F, _F, _F, _I, _I, _I, _I, _I, _VP],
        # llr, out, edge_col, var_edges, batch, n, m, dc, dv, iters,
        # weights (host f32), traj, bucket, warps, frames, stream
        "nms_edge_decode_nmsr": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                 _VP, _I, _I, _I, _I, _VP],
    },
    "osd_disc": {
        # m_matrix, u_l, teps, out, batch, m, k, ntot, then the resident
        # plan (kch, tn, m_pad, k_pad, nt, n_tiles, nbuf, grid_x,
        # smem_bytes), stream
        "lterm_launch": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _VP],
        # m_matrix, u_l, teps, out, batch, m, k, ntot, t_cols, then the
        # general plan (m_pad, k_pad, kslice, stages, nt, n_tiles, grid_x,
        # smem_bytes), stream
        "lterm_general_launch": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _VP],
        # m_matrix, u_l, teps, c0, u_m, offsets, cols, block_of, starts,
        # keys, minima, argmins, batch, m, k, ntot, nreal, blocks, then the
        # resident plan (kch, tn, m_pad, k_pad, nt, n_tiles, nbuf, grid_x,
        # smem_bytes), stream
        "block_minima_launch": [_VP] * 12 + [_I] * 15 + [_VP],
        # m_matrix, u_l, teps, c0, u_m, offsets, cols, block_of, keys, batch,
        # m, k, ntot, nreal, blocks, t_cols, then the general plan (m_pad,
        # k_pad, kslice, stages, nt, n_tiles, grid_x, smem_bytes), stream
        "block_minima_general_launch": [_VP] * 9 + [_I] * 15 + [_VP],
        # keys, starts, minima, argmins, batch, blocks, stream
        "minima_decode": [_VP, _VP, _VP, _VP, _I, _I, _VP],
        # kch, tn, m_pad, smem_bytes, minima, device, out (int32 [6])
        "lterm_occupancy": [_I, _I, _I, _I, _I, _I, _VP],
    },
    "mc_fused": {
        # bucket, warps, frames, k, stage, table_words, out (int32 [7])
        "mc_frames_occupancy": [_I, _I, _I, _I, _I, _I, _VP],
        # ids, src, msgs_in, msgs_out, stat, counters, edge_col, var_edges,
        # split, encode, count, n, m, dc, dv, k, p, iters, bucket, warps,
        # frames, lanes, grid, table_shared, seed, sigma, mean, w_vc, w_chk,
        # w_marg, stream
        "mc_frames": [_VP] * 10 + [_I] * 14 + [_U, _F, _F, _F, _F, _F, _VP],
        # stat, ids_in, ids_out, src_out, partials, groups, group_size,
        # rows_next, stream
        "mc_group_rank": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    },
    "nms_dense": {
        # bucket, warps, frames, lanes, m, n, dc, dv, k, p
        "dense_max_blocks": [_I] * 10,
        # h, llr, out, batch, m, n, dc, dv, iters, bucket, warps, frames,
        # lanes, blocks, w_vc, w_chk, w_marg, stream
        "dense_decode": [_VP, _VP, _VP] + [_I] * 11 + [_F, _F, _F, _VP],
        # h, encode, p, partials, count, m, n, k, dc, dv, iters, bucket,
        # warps, frames, lanes, blocks, seed, sigma, mean, w_vc, w_chk,
        # w_marg, stream
        "dense_mc": [_VP, _VP, _I, _VP] + [_I] * 12
                    + [_U, _F, _F, _F, _F, _F, _VP],
    },
    "gf2_ge": {
        # perm, hcol, mw, dense, out, order, batch, m, n, c0, then the plan
        # (mode, words, cols, threads, grid), stream
        "ge_launch": [_VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _VP],
        # m, n, mode, words, cols, threads, device, out (int32 [6])
        "ge_occupancy": [_I, _I, _I, _I, _I, _I, _I, _VP],
    },
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> dict[str, float]:
    """Compile every source that has no current build, in parallel; return
    the seconds each build took (0 for a library already built).  Each
    build that succeeded adds one to the set-up counter
    ``kernels_built``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        tmp = out + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        profiling.setup_count("kernels_built", 1)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return dict(BUILD_SECONDS)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building all sources on first use
    (set-up span ``setup.kernels``)."""
    with _lock:
        if name not in _libs:
            with profiling.setup_span("kernels"):
                build_all()
                for src in SOURCES:
                    lib = ctypes.CDLL(_lib_path(src))
                    for fn, argtypes in _SIGNATURES[src].items():
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = ctypes.c_int
                    _libs[src] = lib
        return _libs[name]


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
