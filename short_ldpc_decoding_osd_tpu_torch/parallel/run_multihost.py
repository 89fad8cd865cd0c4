"""Multi-process Monte-Carlo FER sweep (port of ``scripts/run_multihost.py``).

Run one copy a process, each on its own card:

    python -m short_ldpc_decoding_osd_tpu_torch.parallel.run_multihost \\
        --coordinator <host0>:1234 --num-processes 4 --process-id $ID \\
        --snrs 2.0:3.5:7

Each process joins the ``torch.distributed`` group (NCCL on CUDA, gloo on
the CPU, or ``--backend``); the frames split over the ranks and the
counters are summed over them, so every rank takes the same early-stop
decisions.  Rank 0 prints one JSON line a point and writes the curve.  With
one process (no coordinator) it is a world of one.  Two processes that
share one card need ``--backend gloo``: NCCL refuses two ranks on one
device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch.distributed as dist

from ..codes import get_code
from ..convert import load_jax_pickle
from ..mc.harness import run_nms_mc
from ..ops import nms
from ..utils.metrics import wilson_interval
from .data_parallel import MESH_RUNGS
from .mesh import init_multihost, make_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None, help="host0 address:port")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--code", default="ccsds_128_64")
    ap.add_argument("--variant", default="NMS-1")
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--snrs", default="2.0:3.5:7")
    ap.add_argument("--per-device-batch", type=int, default=16384)
    ap.add_argument("--error-budget", type=int, default=40000)
    ap.add_argument("--max-frames", type=int, default=10**9)
    ap.add_argument("--params", default=None,
                    help="pickle of trained params (either package's)")
    ap.add_argument("--out", default="runs/multihost_fer.json")
    ap.add_argument("--mesh-rung", choices=MESH_RUNGS, default=None,
                    help="pin the fused rung on every rank (run_nms_mc's "
                         "rung=): compact (K3), oneshot (K4), xla (the "
                         "plain decoder on one global sample)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on cuda, "
                         "gloo on cpu)")
    args = ap.parse_args(argv)

    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   backend=args.backend, device=args.device)
    try:
        _sweep(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _sweep(args) -> None:
    code = get_code(args.code)
    if args.params:
        params = load_jax_pickle(args.params)
    else:
        params = nms.init_params(args.variant, code.h)
    mesh = make_mesh(device=args.device)
    lo, hi, num = args.snrs.split(":")
    points = []
    for snr in np.linspace(float(lo), float(hi), int(num)):
        t0 = time.time()
        stats, _ = run_nms_mc(
            code, params, args.variant, args.iterations, float(snr),
            batch=args.per_device_batch, error_budget=args.error_budget,
            max_frames=args.max_frames, seed=int(snr * 1000),
            rung=args.mesh_rung, mesh=mesh)
        ci = wilson_interval(stats.frame_errors, stats.frames)
        point = {
            "snr_db": float(snr), **stats.to_dict(), "fer_ci": list(ci),
            "frames_per_s": stats.frames / max(time.time() - t0, 1e-9),
            "devices": mesh.size,
            "hosts": mesh.size,  # one process a device
        }
        points.append(point)
        if mesh.rank == 0:
            print(json.dumps(point), flush=True)
    if mesh.rank == 0:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "wt") as fh:
            json.dump({"points": points}, fh, indent=1)


if __name__ == "__main__":
    main()
