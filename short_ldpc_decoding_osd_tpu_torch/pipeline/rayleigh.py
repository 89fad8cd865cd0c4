"""Two-phase (NMS + DIA-OSD) FER under Rayleigh block fading (port of
``scripts/rayleigh_two_phase.py``).

The reference's fading option lives in its test-data generator
(``Testing_data_gen_128/data_generating.py:21-38``) and feeds the same
evaluation pipeline; this module does the equivalent system-level run:
capture fading failures with the trained NMS (the capture step, K1 on the
card; a fading spec never takes the fused counters), then walk them with
the trained DIA, stopper and path through the raw-LLR phase-2 step (K2,
the GE kernel, K5).  The DIA and stopper are the run directory's
AWGN-trained artifacts, as the reference's flow would use them unless
retrained on fading data; each point records that.

    python -m short_ldpc_decoding_osd_tpu_torch.pipeline.rayleigh \\
        [--run runs/r4_pipeline] [--snrs 6.0,8.0,10.0] [--budget 500] \\
        [--fade-duration 1] [--out runs/r5_rayleigh] [--device cuda|cpu]

``--fade-duration`` d gives fading blocks of 16 d bits.  The points go to
``two_phase_rayleigh.json`` in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import convert
from .._device import resolve_device
from ..channel import ChannelSpec
from ..mc.harness import run_nms_mc
from ..osd import engine, segments

# the capture sweep of every point: steps of BATCH frames up to MAX_FRAMES,
# step generators seeded from SEED (the error budget never stops it early)
BATCH, MAX_FRAMES, SEED = 65536, 2**21, 515


def run_points(run_dir: str, snrs, budget: int = 500, fade_duration: int = 1,
               batch: int = BATCH, max_frames: int = MAX_FRAMES,
               device: str | torch.device = "cuda", log=print) -> list[dict]:
    """One point a SNR: ``max_frames`` fading frames through the capture
    step, the first ``budget`` detected failures' raw LLR rows walked by the
    phase-2 step; rows its re-decode does not confirm are left out of the
    OSD statistics."""
    dev = resolve_device(device)
    run = convert.load_run(run_dir, dev)
    cfg, code = run["config"], run["code"]
    variant, iters = run["variant"], run["num_iterations"]
    nms_params = {k: v.cpu() for k, v in run["nms_params"].items()}
    layout = segments.TepLayout.build(
        run["path"], code.k, int(cfg.get("num_segments", 6)), dev)
    step = engine.make_dl_osd_step_from_llr(
        run["dia"], code, variant, iters, layout,
        window=int(cfg.get("window", 5)),
        soft_margin=float(cfg.get("soft_margin", 0.9)))

    points = []
    for snr in (float(s) for s in snrs):
        t0 = time.time()
        spec = ChannelSpec.rayleigh_spec(snr, code.rate, duration=fade_duration)
        stats, fb = run_nms_mc(
            code, nms_params, variant, iters, snr, batch=batch,
            error_budget=10**9, max_frames=max_frames, seed=SEED, spec=spec,
            capture_failures=True, capture_limit=budget,
            capture_trajectories=False, device=dev)
        llr = torch.as_tensor(fb.trajectories[:budget, 0], device=dev)
        labels = torch.as_tensor(fb.labels[:budget], device=dev)
        with torch.no_grad():
            out, _, det = step(nms_params, llr, labels, run["fcn"])
        d = det.cpu().numpy()
        succ = out["success"].cpu().numpy() & d
        nv = int(d.sum())
        fer_nms = stats.detected_failures / max(stats.frames, 1)
        fer_osd = float((nv - succ.sum()) / max(nv, 1))
        point = {
            "snr_db": snr,
            "channel": "rayleigh",
            "fade_block_bits": 16 * fade_duration,
            "frames": stats.frames,
            "fer_nms_detected": fer_nms,
            "ufer": stats.ufer,
            "osd_walked": nv,
            "osd_success": int(succ.sum()),
            "fer_osd": fer_osd,
            "fer_total": fer_nms * fer_osd + stats.ufer,
            "dia_training_channel": "awgn (trained artifacts from --run)",
            "time_s": round(time.time() - t0, 1),
        }
        points.append(point)
        log(json.dumps(point))
    return points


def main(argv=None, batch: int = BATCH, max_frames: int = MAX_FRAMES) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default="runs/r4_pipeline")
    ap.add_argument("--snrs", default="6.0,8.0,10.0")
    ap.add_argument("--budget", type=int, default=500)
    ap.add_argument("--fade-duration", type=int, default=1,
                    help="fading blocks of 16 x this many bits")
    ap.add_argument("--out", default="runs/r5_rayleigh")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    points = run_points(args.run, args.snrs.split(","), args.budget,
                        args.fade_duration, batch, max_frames, args.device,
                        log=lambda line: print(line, flush=True))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "two_phase_rayleigh.json"), "wt") as fh:
        json.dump({"points": points}, fh, indent=1)


if __name__ == "__main__":
    main()
