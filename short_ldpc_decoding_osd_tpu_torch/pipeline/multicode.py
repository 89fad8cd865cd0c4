"""The full two-phase recipe on codes beyond CCSDS (128,64) (port of
``scripts/multicode_recipe.py``): NMS training, failure harvest, DIA and
decoding path, stopper, and the DL-OSD FER sweep, one run directory a code
under ``--out-root``, including a rank-deficient H (``array_121_60``
decodes on its 66-row H and runs OSD on its 61-row full-rank basis).

    python -m short_ldpc_decoding_osd_tpu_torch.pipeline.multicode \\
        [--codes a,b] [--quick] [--out-root DIR] [--device cuda|cpu]

Each code's stages go through :func:`recipe.run_recipe`, which reuses every
artifact its run directory already holds (a run directory seeded with
``nms_params.pkl`` skips the NMS training).  ``summary.json`` in
``--out-root`` gets each code's elapsed seconds and points, merged into
the file's earlier codes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .._device import resolve_device
from .recipe import RecipeConfig, run_recipe

PLANS = {
    "regular_256_128": dict(snrs="2.0:3.0:3", nms=8000, osd=200, train=6000),
    # 600 OSD failures/point: at 200 the 2.5 vs 3.0 dB points inverted from
    # small-sample noise (2 vs 4 failures)
    "array_121_60": dict(snrs="2.0:3.5:4", nms=8000, osd=600, train=6000),
    # r4 additions: the QC code and the WiMAX-like protograph code from the
    # reference's asset set (rate 1/2; higher-SNR windows)
    "qc_96_48": dict(snrs="2.0:3.5:4", nms=8000, osd=400, train=6000),
    "wimaxlike_384_192": dict(snrs="1.5:2.5:3", nms=8000, osd=400, train=6000),
    # the production-scale rate-0.83 WiMAX code (8.25x the flagship's n): a
    # scale proof at reduced budgets in its (higher) operating window.  The
    # flagship OSD point does NOT transfer: at k=880 a threshold_sum=3
    # learned path reached 14.3M TEPs (weight-3 patterns over ~300-bit
    # segments — measured, would run for hours); order-2 x 16 blocks keeps
    # the TEP count ~100k while still exercising every stage at scale
    "wimax_1056_880": dict(snrs="3.25:4.0:2", nms=3000, osd=200, train=4000,
                           training_snr=3.75, threshold_sum=2,
                           decoding_length=16),
}


def code_plan(name: str, quick: bool = False):
    """(``RecipeConfig``, SNR points) of one code's plan; ``quick`` takes the
    pipeline-smoke budgets (500 NMS errors, 30 OSD failures, 800 harvested
    failures)."""
    plan = dict(PLANS[name])
    nms_budget = plan.pop("nms")
    osd_budget = plan.pop("osd")
    train_target = plan.pop("train")
    snrs = plan.pop("snrs")
    if quick:
        nms_budget, osd_budget, train_target = 500, 30, 800
    lo, hi, num = snrs.split(":")
    points = np.linspace(float(lo), float(hi), int(num))
    cfg = RecipeConfig(
        code_name=name,
        nms_error_budget=nms_budget,
        osd_failure_budget=osd_budget,
        train_failure_target=train_target,
        max_frames_per_snr=10**8,
        eval_batch=4096,
        **plan,
    )
    return cfg, points


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--codes", default=",".join(PLANS))
    ap.add_argument("--quick", action="store_true",
                    help="tiny budgets (pipeline smoke, not a curve)")
    ap.add_argument("--out-root", default="runs/r3_multicode")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    summary = {}
    for name in args.codes.split(","):
        cfg, points = code_plan(name, args.quick)
        t0 = time.time()
        print(f"=== {name} ===", flush=True)
        curve = run_recipe(cfg, os.path.join(args.out_root, name), points,
                           device=device)
        summary[name] = {
            "elapsed_s": time.time() - t0,
            "points": [
                {k: p[k] for k in
                 ("snr_db", "fer_nms_detected", "fer_osd", "fer_total",
                  "frames")}
                for p in curve["points"]
            ],
        }
        print(json.dumps(summary[name]), flush=True)
    os.makedirs(args.out_root, exist_ok=True)
    path = os.path.join(args.out_root, "summary.json")
    if os.path.exists(path):  # merge: partial --codes runs must not clobber
        with open(path) as fh:
            summary = {**json.load(fh), **summary}
    with open(path, "wt") as fh:
        json.dump(summary, fh, indent=1)


if __name__ == "__main__":
    main()
