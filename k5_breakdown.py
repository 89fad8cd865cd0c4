"""Where K5's time goes on the card: the kernel beside variants of its sum.

    python3 k5_breakdown.py

Builds three variants of ``short_ldpc_decoding_osd_tpu_torch/csrc/osd_disc.cu``
beside the kernel itself, each by a text substitution of the source, and
times all four with CUDA events at K5's shapes (the main path's 32,768 x 64
x 64 x 1,536, which runs the resident plan, and wimaxlike_384_192's
multicode 400 x 192 x 192 x 58,368 and the WiMAX round's 1,024 x 176 x 880
x 102,912, which run the general plan), in turns.  The substitutions hit
the epilogue both plans share (``Partials``, ``add_if_odd``), so each
variant changes the resident and the general kernel alike:

* ``kernel``: the source as it is (exact f64 sum, predicated adds);
* ``f32_sum``: the same sum in f32 (faster, not exact);
* ``select_sum``: the f64 sum written as ``if (acc & 1) s += u`` in C;
* ``no_sum``: the sum replaced by an integer xor of the accumulators, so
  what is left is the MMAs, the loads and the stores.

Each line gives the variant's milliseconds and its largest error relative
to an f64 evaluation (the ``no_sum`` error is meaningless by design).  The
inputs are synthetic 0/1 matrices and N(0, 1.5) weights from
``np.random.default_rng(1)``.  Needs a CUDA card and ``nvcc``; prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from short_ldpc_decoding_osd_tpu_torch import _kernels
from short_ldpc_decoding_osd_tpu_torch.ops import osd_disc

SHAPES = ((32768, 64, 64, 1536), (400, 192, 192, 58368), (1024, 176, 880, 102912))
OUT_DIR = os.path.join(os.path.dirname(_kernels.BUILD_DIR), "k5_breakdown")
PREDICATED_ADD = '''  asm("{\\n"
      "  .reg .pred p;\\n"
      "  .reg .b32 t;\\n"
      "  and.b32 t, %1, 1;\\n"
      "  setp.ne.b32 p, t, 0;\\n"
      "  @p add.f64 %0, %0, %2;\\n"
      "}\\n"
      : "+d"(s)
      : "r"(acc), "d"(u));'''
WEIGH = '''    add_if_odd(s[0], acc[0], u.x);
    add_if_odd(s[1], acc[1], u.y);
    add_if_odd(s[2], acc[2], u.x);
    add_if_odd(s[3], acc[3], u.y);'''


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"osd_disc.cu no longer holds {old[:40]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    f32 = src
    for old, new in (("double2", "float2"), ("double", "float"),
                     ("add.f64", "add.f32"), ('"+d"', '"+f"'),
                     ('"d"(u)', '"f"(u)'), ("__float2float_rn(", "(")):
        f32 = f32.replace(old, new)
    no_sum = _replace(src, WEIGH, "    ip[0] += acc[0] ^ acc[1];\n"
                                  "    ip[1] += acc[2] ^ acc[3];")
    no_sum = _replace(no_sum, "  double s[4] = {0.0, 0.0, 0.0, 0.0};",
                      "  double s[4] = {0.0, 0.0, 0.0, 0.0};\n"
                      "  int ip[2] = {0, 0};")
    no_sum = _replace(no_sum, "    s0 = s[0] + s[1];\n    s1 = s[2] + s[3];",
                      "    s0 = ip[0];\n    s1 = ip[1];")
    return {"kernel": src, "f32_sum": f32,
            "select_sum": _replace(src, PREDICATED_ADD, "  if (acc & 1) s += u;"),
            "no_sum": no_sum}


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
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{name}: ptxas {regs}", flush=True)
        libs[name] = ctypes.CDLL(lib)
        for entry in ("lterm_launch", "lterm_general_launch"):
            getattr(libs[name], entry).argtypes = \
                _kernels._SIGNATURES["osd_disc"][entry]
    return libs


def launch(lib, m_mat, u_l, teps, out):
    b, m, k = m_mat.shape
    plan = osd_disc.lterm_plan(b, m, k, teps.shape[0],
                               torch.cuda.get_device_properties(
                                   m_mat.device).multi_processor_count)
    _kernels.check(osd_disc.launch(lib, plan, m_mat, u_l, teps, out),
                   "lterm_launch")


def cuda_ms(fn, reps: int = 20) -> float:
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


def exact(m_mat, u_l, teps):
    """f64 evaluation, as many frames a call as keep its products under
    2 GiB."""
    t = teps.double()
    chunk = max(1, 2**31 // (8 * m_mat.shape[1] * teps.shape[0]))
    outs = []
    for s in range(0, m_mat.shape[0], chunk):
        prods = torch.einsum("bmk,nk->bmn", m_mat[s:s + chunk].double(), t)
        outs.append(torch.einsum("bm,bmn->bn", u_l[s:s + chunk].double(),
                                 prods.remainder_(2.0)))
    return torch.cat(outs)


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_breakdown: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    with open(os.path.join(_kernels.CSRC_DIR, "osd_disc.cu")) as fh:
        libs = build(variants(fh.read()))
    dev = torch.device("cuda")
    for b, m, k, ntot in SHAPES:
        rng = np.random.default_rng(1)
        m_mat, u_l, teps = (torch.as_tensor(a, device=dev) for a in (
            rng.integers(0, 2, (b, m, k)).astype(np.int8),
            rng.normal(0, 1.5, (b, m)).astype(np.float32),
            rng.integers(0, 2, (ntot, k)).astype(np.int8)))
        ref = exact(m_mat, u_l, teps)
        out = torch.empty((b, ntot), dtype=torch.float32, device=dev)
        cells = []
        for name in list(libs) + list(libs)[::-1]:
            launch(libs[name], m_mat, u_l, teps, out)
            err = float(((out.double() - ref).abs() / ref.abs().clamp(min=1.0))
                        .max())
            ms = cuda_ms(lambda: launch(libs[name], m_mat, u_l, teps, out))
            cells.append(f"{name} {ms:.4f} ms (rel err {err:.2g})")
        print(f"K5 M ({b}, {m}, {k}) x T ({ntot}, {k}): " + "; ".join(cells),
              flush=True)
        del ref, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
