"""Where the GE kernel's time goes on the card: the kernel beside variants.

    python3 ge_breakdown.py              # the kernel beside its variants
    python3 ge_breakdown.py --wrappers   # the wrappers alone, any tree

Builds three variants of ``short_ldpc_decoding_osd_tpu_torch/csrc/gf2_ge.cu``
beside the kernel itself, each by a text substitution of the source, and
times all four back to back with CUDA events (20 launches between two
events, outputs allocated once) on the perm load at the GE shapes of
``chip_smoke.py``, in turns (kernel first and last):

* ``kernel``: the source as it is;
* ``no_steps``: the elimination left out, so what is left is the gather of
  H's packed columns and the stores of the tail and the order;
* ``no_tail``: the tail's 16-byte stores left out (their transposes
  kept), so what is left is the gather, the steps and the order;
* ``no_gather``: H's packed columns not read (made from the permutation
  index instead), the perm still read.

Beside them ``tail_fill`` is ``Tensor.fill_`` of a tensor of the tail's
size: the card's rate for writing those bytes.  The variants' results are
wrong by design; only ``kernel`` is a GE.

``--wrappers`` times only the public wrappers, ``reduce_from_perm`` at the
same shapes and ``reduce_dense`` at the main path's (one call between two
events, host work included; and back to back), beside each shape's bound
as ``chip_smoke.py`` reckons it.  It uses nothing else of the package, so
a copy of this script runs against an older tree of the port (run it from
that tree's root) for an A/B comparison.  Permutations come from
``torch.Generator(device="cuda").manual_seed(8)``.  Needs a CUDA card and
``nvcc``; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from short_ldpc_decoding_osd_tpu_torch import _kernels
from short_ldpc_decoding_osd_tpu_torch.codes import get_code, tables
from short_ldpc_decoding_osd_tpu_torch.ops import gf2_bitpack

SHAPES = (("ccsds_128_64", 32768), ("qc_96_48", 4096),
          ("wimaxlike_384_192", 4096), ("wimax_1056_880", 1024),
          ("wimax_1056_880", 8192))
OUT_DIR = os.path.join(os.path.dirname(_kernels.BUILD_DIR), "ge_breakdown")
STEPS = "  steps<MW, CPT, WARP, 0>(col, fs, nsw, tid, nthr, m, n);"
TAIL = "        if (r < m) store_bits(o + r * kt, g - c0, y, lo, hi);"
GATHER = "          if (w < mw) col[s][w] = hcol[j * mw + w];"


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"gf2_ge.cu no longer holds {old[:40]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    return {
        "kernel": src,
        "no_steps": _replace(src, STEPS, ""),
        # c0 >= 0 always, which the compiler cannot know: the transposes stay
        "no_tail": _replace(src, TAIL, TAIL.replace("r < m", "r < m && c0 < 0")),
        "no_gather": _replace(src, GATHER, GATHER.replace(
            "hcol[j * mw + w]",
            "static_cast<uint32_t>(j * 2654435761ll + w * 40503)")),
    }


def build(sources: dict) -> dict:
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _kernels._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-o", lib, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].ge_launch.argtypes = _kernels._SIGNATURES["gf2_ge"]["ge_launch"]
    return libs


def back_to_back_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def one_call_ms(fn, reps: int = 10) -> float:
    """Median ms of one call between two events (host work included)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def bound_ms(b, m, n, k, load) -> str:
    """As chip_smoke.py's ge_bound: bytes at 3.35 TB/s against B m^2 nw
    word XORs on 64 INT32 lanes an SM (16.75 T/s)."""
    nbytes = (8 * b * n if load == "perm" else b * m * n) + b * m * k + 4 * b * n
    t_bytes, t_ops = nbytes / 3.35e12, b * m * m * -(-n // 32) / 16.75e12
    return (f"{1e3 * max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")


def wrappers() -> None:
    from short_ldpc_decoding_osd_tpu_torch.ops import gf2ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, b in SHAPES:
        code = get_code(name)
        h, k, n = code.h_osd, code.k, code.n
        m = h.shape[0]
        perm = torch.argsort(torch.rand((b, n), generator=gen, device=dev),
                             dim=1)
        cases = [("perm", lambda: gf2_bitpack.reduce_from_perm(perm, h, k))]
        if name == "ccsds_128_64":
            dense = gf2ops.permute_columns(perm, h)
            cases.append(("dense", lambda: gf2_bitpack.reduce_dense(dense, k)))
        for load, fn in cases:
            print(f"GE wrapper {name} h_osd, {b} frames of {m} x {n}, {load} "
                  f"load: one call {one_call_ms(fn):.4f} ms, back to back "
                  f"{back_to_back_ms(fn):.4f} ms, bound "
                  f"{bound_ms(b, m, n, k, load)}", flush=True)
        del perm, cases
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("ge_breakdown: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    if "--wrappers" in sys.argv[1:]:
        wrappers()
        return 0
    with open(os.path.join(_kernels.CSRC_DIR, "gf2_ge.cu")) as fh:
        libs = build(variants(fh.read()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, b in SHAPES:
        code = get_code(name)
        h, k, n = code.h_osd, code.k, code.n
        m = h.shape[0]
        perm = torch.argsort(torch.rand((b, n), generator=gen, device=dev),
                             dim=1)
        hcol = tables.get(h, gf2_bitpack._packed_h_columns, dev)
        plan = gf2_bitpack.ge_plan(b, m, n)
        out = torch.empty((b, m, k), dtype=torch.int8, device=dev)
        order = torch.empty((b, n), dtype=torch.int32, device=dev)
        args = (perm.data_ptr(), hcol.data_ptr(), hcol.shape[1], 0,
                out.data_ptr(), order.data_ptr(), b, m, n, n - k,
                0 if plan.mode == "warp" else 1, plan.words, plan.cols,
                plan.threads, plan.grid, _kernels.stream_handle(dev))

        def launch(lib):
            _kernels.check(lib.ge_launch(*args), "ge_launch")

        cells = []
        for vn in list(libs) + ["kernel"]:
            ms = back_to_back_ms(lambda: launch(libs[vn]))
            cells.append(f"{vn} {ms:.4f}")
        cells.append(f"tail_fill {back_to_back_ms(lambda: out.fill_(1)):.4f}")
        print(f"GE {name} h_osd, {b} frames of {m} x {n}, {plan.mode} mode "
              f"(ms): " + "; ".join(cells), flush=True)
        del perm, out, order
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
