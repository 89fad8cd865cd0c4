"""Build the NMS-r two-phase run directory on the card.

``runs/r4_pipeline``'s recipe config with ``"variant": "NMS-r"``; stage 1
reused from the trained NMS-r weights of ``runs/r5_variants_nmsr`` (copied
in, not retrained); stages 2-5 (failure harvest at the config's training
SNR, the DIA and its decoding path, the stopper, the FER sweep at 2.0,
2.2, ..., 3.0 dB) trained by ``pipeline.recipe.run_recipe``.  The
config's ``seed`` seeds the recipe.

    python3 scripts/nmsr_run_dir.py --out runs/r27_nmsr_pipeline

refuses an ``--out`` that exists and prints the FER curve's points and the
stage seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "runs", "r4_pipeline")
WEIGHTS = os.path.join(ROOT, "runs", "r5_variants_nmsr", "nms_params.pkl")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    from short_ldpc_decoding_osd_tpu_torch.pipeline import recipe

    if os.path.exists(args.out):
        raise SystemExit(f"{args.out} exists")
    with open(os.path.join(BASE, "config.json")) as fh:
        cfg = json.load(fh)
    cfg["frame_portions"] = tuple(cfg.get("frame_portions", ()))
    cfg = dataclasses.replace(recipe.RecipeConfig(**cfg), variant="NMS-r")
    os.makedirs(args.out)
    shutil.copy(WEIGHTS, args.out)
    curve = recipe.run_recipe(cfg, args.out, snrs=np.linspace(2.0, 3.0, 6), log=print,
                              device="cuda")
    for point in curve["points"]:
        print(json.dumps({k: point[k] for k in ("snr_db", "frames",
                                                "fer_nms_detected",
                                                "fer_total")}))
    with open(os.path.join(args.out, "stage_seconds.json")) as fh:
        print(fh.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
