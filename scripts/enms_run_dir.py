"""Build the ENMS run directory of the WiMAX (1056,880) code on the card.

``runs/r5_multicode/wimax_1056_880``'s recipe config with ``"variant":
"ENMS"``, every stage trained by ``pipeline.recipe.run_recipe``: ENMS's
check factor on the extended parity matrix (``Code.extended``: H and its
pairwise row sums of weight <= 2 dc - 4, 220 x 1,056), the failure
harvest at the config's training SNR (3.75 dB), the DIA and its decoding
path, the stopper, and the FER sweep at 3.25, 3.5, 3.75 and 4.0 dB.  The
config's ``seed`` seeds the recipe.

    python3 scripts/enms_run_dir.py --out runs/r29_enms_wimax

refuses an ``--out`` that exists and prints the FER curve's points and the
stage seconds.  ``--train-failure-target`` lowers the harvest's target
(the config's 4,000) where the DIA-and-path stage would run too long; the
run directory's config then records the value used.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "runs", "r5_multicode", "wimax_1056_880")
SNRS = (3.25, 3.5, 3.75, 4.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--train-failure-target", type=int, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    from short_ldpc_decoding_osd_tpu_torch.pipeline import recipe

    if os.path.exists(args.out):
        raise SystemExit(f"{args.out} exists")
    with open(os.path.join(BASE, "config.json")) as fh:
        cfg = json.load(fh)
    cfg["frame_portions"] = tuple(cfg.get("frame_portions", ()))
    cfg = dataclasses.replace(recipe.RecipeConfig(**cfg), variant="ENMS")
    if args.train_failure_target is not None:
        cfg = dataclasses.replace(
            cfg, train_failure_target=args.train_failure_target)
    os.makedirs(args.out)
    curve = recipe.run_recipe(cfg, args.out, snrs=SNRS, log=print,
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
